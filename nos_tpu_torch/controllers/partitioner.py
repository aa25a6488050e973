"""Port of `nos_tpu/controllers/partitioner.py:1` (:1-645):
`PartitionerController` (:36). Copied verbatim; only the imports point at
the port, which imports nothing of the JAX package.

The central partitioner controller.

Analog of internal/controllers/gpupartitioner/partitioner_controller.go:81-232:
watches pods, batches the unschedulable ones whose situation extra fractional
resources could help, gates planning on the plan-id handshake (never plan while
a node hasn't reported the last plan), and on batch close runs
snapshot -> plan -> actuate.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api import annotations as ann
from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import compute_pod_request
from nos_tpu_torch.cluster.client import Cluster, Event, EventType
from nos_tpu_torch.partitioning.core import Actuator, Planner
from nos_tpu_torch.partitioning.core.planner import PartitioningPlan
from nos_tpu_torch.partitioning.core.interface import (
    NodePartitioning,
    Partitioner,
    SimScheduler,
    SnapshotTaker,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.util import pod as podutil
from nos_tpu_torch.util.batcher import Batcher

logger = logging.getLogger(__name__)


class PartitionerController:
    def __init__(
        self,
        cluster: Cluster,
        state: ClusterState,
        kind: str,
        snapshot_taker: SnapshotTaker,
        partitioner: Partitioner,
        sim_scheduler: SimScheduler,
        batch_timeout_s: float = constants.DEFAULT_BATCH_WINDOW_TIMEOUT_S,
        batch_idle_s: float = constants.DEFAULT_BATCH_WINDOW_IDLE_S,
        resync_s: float = constants.DEFAULT_PARTITIONER_RESYNC_S,
        enable_consolidation: bool = True,
        defrag_budget: int = 0,
        migration_hold_s: float = 120.0,
        checkpoint_preempt_after_s: float = 120.0,
        checkpoint_min_gain_s: float = 60.0,
        checkpoint_victim_cooldown_s: float = 300.0,
        checkpoint_victim_budget: int = 3,
        checkpoint_victim_window_s: float = 3600.0,
        now=None,
    ):
        self.cluster = cluster
        self.state = state
        self.kind = kind
        self.snapshot_taker = snapshot_taker
        # defrag_budget > 0 arms the planner's slice-migration pass; each
        # migration is actuated through the ordered move protocol and
        # reserved in ClusterState for `migration_hold_s` so concurrent
        # replans can't double-claim the destination before the mover
        # rebinds (a lost mover lapses the reservation at expiry).
        self.defrag_budget = defrag_budget
        self.migration_hold_s = migration_hold_s
        self.planner = Planner(sim_scheduler, defrag_budget=defrag_budget)
        self.actuator = Actuator(
            partitioner, self._current_partitioning, evict=self._evict
        )
        self._hold_nodes: set = set()  # nodes carrying our hold annotation
        import time as _time

        # Wall clock, NOT monotonic: pending-age math compares against pod
        # creation timestamps, which are wall-clock epoch both on the
        # in-memory bus (Cluster's now default) and over the kube wire codec
        # (ISO timestamps -> epoch). A monotonic default would make every
        # age hugely negative in a real deployment and silently disable the
        # checkpoint fallback.
        self._now = now if now is not None else _time.time
        # Interval math (resync cadence) runs on a MONOTONIC clock so an NTP
        # step can neither delay the periodic replan nor fire it early; wall
        # clock is only for creation-timestamp age comparisons, which are
        # epoch-based on the wire. An injected clock drives both (virtual
        # time in simulation keeps one timeline).
        self._mono = now if now is not None else _time.monotonic
        kwargs = {"now": now} if now is not None else {}
        self.batcher: Batcher[Pod] = Batcher(batch_timeout_s, batch_idle_s, **kwargs)
        self.resync_s = resync_s
        self.enable_consolidation = enable_consolidation
        # None disables the checkpoint-aware fallback entirely; it only ever
        # fires for pods ANNOTATED checkpointable, so unannotated clusters
        # behave identically regardless.
        self.checkpoint_preempt_after_s = checkpoint_preempt_after_s
        # Churn discipline on the checkpoint fallback (VERDICT r3 #1): the
        # drain must provably shorten the preemptor's wait vs the natural
        # drain by at least `min_gain`, and no workload may be fallback-
        # evicted more than `budget` times per sliding `window` nor twice
        # within `cooldown` — without these bounds an all-checkpointable
        # trace degenerates into an eviction storm (round-3 live-lock:
        # 155 preemptions, 11/200 jobs stranded).
        self.checkpoint_min_gain_s = checkpoint_min_gain_s
        self.checkpoint_victim_cooldown_s = checkpoint_victim_cooldown_s
        self.checkpoint_victim_budget = checkpoint_victim_budget
        self.checkpoint_victim_window_s = checkpoint_victim_window_s
        from nos_tpu_torch.util.churn import ChurnLedger

        self._churn = ChurnLedger(
            checkpoint_victim_cooldown_s,
            checkpoint_victim_budget,
            checkpoint_victim_window_s,
        )
        # Alias kept for tests/operators poking the raw history.
        self._ckpt_evictions = self._churn.history
        self._last_cycle_at = self._mono()
        self._version_at_last_cycle: Optional[int] = None
        self._age_gate_at: Optional[float] = None
        self._unsub = None
        self._stop = threading.Event()

    # -- watch wiring (partitioner_controller.go:81-149) ---------------------
    def start_watching(self) -> None:
        def on_pod(ev: Event) -> None:
            if ev.type == EventType.DELETED:
                return
            self.reconcile_pod(ev.obj)

        self._unsub = self.cluster.watch("Pod", on_pod)

    def stop(self) -> None:
        self._stop.set()
        if self._unsub:
            self._unsub()

    def reconcile_pod(self, pod: Pod) -> None:
        if not self.state.partitioning_enabled(self.kind):
            return
        if not podutil.extra_resources_could_help_scheduling(pod):
            return
        self.batcher.add(pod)

    # -- the planning cycle --------------------------------------------------
    def waiting_for_plan_reports(self) -> List[str]:
        """Nodes whose status plan id lags their spec plan id
        (partitioner_controller.go:212-232)."""
        lagging = []
        for node in self.state.nodes(
            label_selector={
                constants.LABEL_PARTITIONING: constants.partitioning_label_values(
                    self.kind
                )
            }
        ):
            if not ann.node_reported_last_plan(node.metadata.annotations):
                lagging.append(node.metadata.name)
        return lagging

    def process_batch_if_ready(self) -> bool:
        """One reconcile step; returns True if a planning cycle ran.
        Deterministic — tests call it directly; run() loops it."""
        lagging = self.waiting_for_plan_reports()
        if lagging:
            logger.info(
                "partitioner(%s): waiting for nodes to report last plan: %s",
                self.kind,
                lagging,
            )
            return False
        if not self.batcher.drain_if_ready():
            if not self._resync_due():
                return False
            # Resync exists to retry transient refusals (handshake races,
            # partial applies) — all of which end with some write. With the
            # store version unchanged since the last cycle, the replan would
            # recompute the identical no-op plan; skip it — UNLESS a pending
            # pod has crossed the checkpoint-preemption age threshold since
            # (aging is time-driven, no write announces it; same shape as
            # the scheduler's no-op expiry).
            if self.cluster.version == self._version_at_last_cycle and (
                self._age_gate_at is None or self._now() < self._age_gate_at
            ):
                self._last_cycle_at = self._mono()
                return False
        self._version_at_last_cycle = self.cluster.version
        pods = self.fetch_pending_pods()
        if self.checkpoint_preempt_after_s is not None:
            now = self._now()
            # The gate must fire exactly when the next pod CROSSES the age
            # threshold; already-aged pods need no retry — with an unchanged
            # store version their fallback outcome is deterministic, so the
            # version gate handles reopening on writes.
            crossings = [
                p.metadata.creation_timestamp + self.checkpoint_preempt_after_s
                for p in pods
                if now - p.metadata.creation_timestamp
                < self.checkpoint_preempt_after_s
            ]
            self._age_gate_at = min(crossings) if crossings else None
        if not pods:
            # Still a completed cycle for resync purposes: without the stamp,
            # an idle cluster would re-list all pods every control round once
            # resync_s first elapsed.
            self._last_cycle_at = self._mono()
            return False
        self.state.prune_migrations(self._now())
        snapshot = self.snapshot_taker.take_snapshot(self.state)
        plan = self.planner.plan(snapshot, pods)
        if plan.migrations:
            # Note the reservations BEFORE actuating: the moment the drain
            # deletes a mover pod, watch-driven replans may fire, and they
            # must already see the destination claim.
            from nos_tpu_torch.partitioning.state import MigrationNote

            now = self._now()
            for m in plan.migrations:
                self.state.note_migration(
                    MigrationNote(
                        pod_key=m.pod_key,
                        source_node=m.source_node,
                        dest_node=m.dest_node,
                        request=snapshot.slice_spec.pod_slice_request(m.pod),
                        expires_at=now + self.migration_hold_s,
                    )
                )
            from nos_tpu_torch.observability import metrics

            metrics.inc(
                "nos_tpu_slice_migrations", kind=self.kind, n=len(plan.migrations)
            )
        self._sync_migration_holds()
        self.actuator.apply(plan)
        if self.enable_consolidation:
            self._consolidate(snapshot, pods, plan.placed)
        self._last_cycle_at = self._mono()
        return True

    # -- migration hold annotations (the agents' ladder reads these) --------
    def _sync_migration_holds(self) -> None:
        """Reconcile the per-node migration-hold annotation with the active
        reservations: the node agents' delete ladders must not drop a free
        slice that is an in-flight migration's destination — delete-free-
        first extended to moves. Runs every cycle so expired/cleared
        reservations release their holds promptly."""
        desired: Dict[str, Dict[str, int]] = {}
        for note in self.state.active_migrations():
            per_node = desired.setdefault(note.dest_node, {})
            for resource_name, qty in note.request.items():
                profile = ann.profile_of_resource(resource_name)
                if profile is None or qty <= 0:
                    continue
                per_node[profile] = per_node.get(profile, 0) + int(round(qty))
        for node_name in sorted(self._hold_nodes | set(desired)):
            value = ann.format_migration_hold(desired.get(node_name, {}))

            def mutate(node, value=value):
                if value:
                    node.metadata.annotations[
                        constants.ANNOTATION_MIGRATION_HOLD
                    ] = value
                else:
                    node.metadata.annotations.pop(
                        constants.ANNOTATION_MIGRATION_HOLD, None
                    )

            from nos_tpu_torch.cluster.client import NotFoundError

            node = self.state.get_node(node_name)
            current = (
                node.metadata.annotations.get(constants.ANNOTATION_MIGRATION_HOLD)
                if node is not None
                else None
            )
            if node is not None and (current or None) != (value or None):
                try:
                    self.cluster.patch("Node", "", node_name, mutate)
                except NotFoundError:
                    pass
        self._hold_nodes = set(desired)

    # -- consolidation (defragmentation preemption) --------------------------
    # The reference never migrates running pods: a pending MIG profile that no
    # GPU can host simply waits. On a TPU mesh that policy strands the north
    # star: a pod-sized slice (e.g. 8x8 on a v5e-64 host) binds only when a
    # node drains *naturally*, idling an entire mesh for the duration of its
    # longest straggler. Consolidation drains one node deliberately: pick the
    # cheapest node whose movable pods all provably fit elsewhere RIGHT NOW,
    # evict them (their controllers resubmit; the scheduler rebinds into the
    # verified free capacity), and plan the re-carve. One node per cycle, only
    # while the plan handshake is idle, so convergence stays monotone.
    def _consolidate(self, snapshot, pods: List[Pod], placed: set) -> bool:
        spec = snapshot.slice_spec
        stranded = []
        for pod in pods:
            if pod.metadata.namespaced_name in placed:
                continue
            slice_req = spec.pod_slice_request(pod)
            if not slice_req:
                continue
            if not snapshot.get_lacking_slices(pod):
                continue  # cluster can already host it; not stranded
            chips = sum(spec.slice_weight(k) * v for k, v in slice_req.items())
            stranded.append(
                (-chips, pod.metadata.creation_timestamp, pod.metadata.namespaced_name, pod)
            )
        stranded.sort(key=lambda s: s[:3])
        # Largest-first, bounded attempts: during full saturation every
        # what-if fails (nowhere for victims to go) and the packing calls are
        # the planner's most expensive operation.
        for *_, pod in stranded[:3]:
            if self._consolidate_for(snapshot, pod, checkpoint=False):
                return True
        # Checkpoint fallback passes run OLDEST-first, not largest-first:
        # the oldest stranded pod is by definition the latency-tail risk, and
        # seating a larger-but-younger one instead shuffles the tail upward
        # (measured +30s p95 at checkpointable_fraction=0.3 on the library
        # north-star trace). Pods already attempted above skip the rebind
        # what-if (same snapshot, deterministic — it would fail identically;
        # _victims_fit_elsewhere is the planner's most expensive call).
        tried_rebind = {s[2] for s in stranded[:3]}
        by_age = sorted(stranded, key=lambda s: (s[1], s[2]))
        for _, _, nsname, pod in by_age[:3]:
            if self._consolidate_for(
                snapshot, pod, checkpoint=True, rebind=nsname not in tried_rebind
            ):
                return True
        return False

    @staticmethod
    def _tpu_chips(spec, rl) -> float:
        """Chip-weight of a resource list: slice resources by their profile
        size plus whole-chip requests."""
        return sum(
            spec.slice_weight(k) * v for k, v in rl.items() if spec.is_slice_resource(k)
        ) + rl.get(constants.RESOURCE_TPU, 0.0)

    def _free_chips(self, spec, node) -> float:
        return self._tpu_chips(spec, node.node_info().free)

    def _consolidate_for(
        self, snapshot, pod: Pod, checkpoint: bool = True, rebind: bool = True
    ) -> bool:
        """One consolidation attempt for `pod`. `rebind` runs the
        rebind-proof migration path; `checkpoint` arms the no-rebind-proof
        fallback for aged preemptors over all-checkpointable victims."""
        spec = snapshot.slice_spec
        lacking = dict(spec.pod_slice_request(pod))
        free_by_node = {
            name: self._free_chips(spec, node) for name, node in snapshot.nodes.items()
        }
        total_free = sum(free_by_node.values())
        aged = (
            checkpoint
            and self.checkpoint_preempt_after_s is not None
            and self._now() - pod.metadata.creation_timestamp
            >= self.checkpoint_preempt_after_s
        )
        candidates = []  # (displaced_chips, node_name, drained_node, victims)
        for name in sorted(snapshot.nodes):
            node = snapshot.nodes[name]
            if not hasattr(node, "evict_pods"):
                continue  # node type is not consolidation-capable
            victims = [p for p in node.pods if self._movable(spec, p, pod)]
            if not victims:
                continue
            # Cheap bound before any packing: the victims' chips must fit in
            # the OTHER nodes' free capacity, or the what-if cannot succeed —
            # UNLESS the checkpoint fallback could take this drain anyway
            # (aged preemptor, every victim resumes from checkpoint, so no
            # rebind capacity is required).
            displaced_lb = sum(
                self._tpu_chips(spec, compute_pod_request(p)) for p in victims
            )
            ckpt_eligible = aged and all(
                podutil.is_checkpointable(v) for v in victims
            )
            if (
                displaced_lb > total_free - free_by_node[name] + 1e-9
                and not ckpt_eligible
            ):
                continue
            result = self._drain_plan(spec, node, pod, victims, lacking)
            if result is None:
                continue
            drained, kept_victims = result
            displaced = sum(
                self._tpu_chips(spec, compute_pod_request(p)) for p in kept_victims
            )
            candidates.append((displaced, len(kept_victims), name, drained, kept_victims))
        candidates.sort(key=lambda c: (c[0], c[1], c[2]))
        for _, _, name, drained, victims in candidates if rebind else ():
            rebind_carves = self._victims_fit_elsewhere(snapshot, name, victims)
            if rebind_carves is None:
                continue
            # The plan carries the drained node AND every re-carve the rebind
            # proof relied on — otherwise the "victims provably rebind"
            # guarantee would hinge on a future cycle reproducing the carve
            # before other arrivals claim those chips.
            state = {name: drained.partitioning()}
            state.update(
                {n: other.partitioning() for n, other in rebind_carves.items()}
            )
            plan = PartitioningPlan(state=state)
            logger.info(
                "consolidation: draining %s (%d victims, %d rebind carves) "
                "to host %s (plan %s)",
                name,
                len(victims),
                len(rebind_carves),
                pod.metadata.namespaced_name,
                plan.id,
            )
            for victim in victims:
                self._evict(victim)
            self.actuator.apply(plan)
            from nos_tpu_torch.observability import metrics

            metrics.inc("nos_tpu_consolidations", kind=self.kind)
            return True
        # Checkpoint-aware fallback: no drain had a provable victim rebind
        # (full saturation — nowhere for victims to go NOW). If the stranded
        # pod has aged past the threshold and some drain's victims are ALL
        # checkpointable, evict them anyway: a checkpointable workload
        # resumes from its checkpoint after requeueing, so the cost is a
        # scheduling round trip, not lost work — and without this, a
        # pod-scale request waits out the longest natural drain
        # (docs/dynamic-partitioning.md: the irreducible ~500s p95 under
        # restart-on-preempt semantics).
        if aged and candidates:
            now = self._now()
            # Gain gate: eviction must provably shorten the preemptor's wait
            # vs the natural drain. Every candidate node hosts the preemptor
            # anyway once its victims finish (completion writes reopen the
            # version gate and the resync replans); when the earliest stamped
            # natural drain is within `checkpoint_min_gain_s`, waiting costs
            # less than an eviction round trip. Unknown-duration victims
            # count as an unbounded natural wait — no stamp means no bound,
            # so eviction trivially shortens it.
            known_waits = []
            for _, _, _, _, victims in candidates:
                end = podutil.latest_expected_end(victims, now)
                if end is not None:
                    known_waits.append(end - now)
            if known_waits and min(known_waits) <= self.checkpoint_min_gain_s:
                return False
            blocked_until = []
            # Longest-natural-wait drain first (unknown stamps sort first as
            # unbounded): draining the node that would free LAST maximizes
            # the gain AND leaves the earliest-draining nodes to the other
            # waiting pods — picking the cheapest-displaced drain instead can
            # steal exactly the drain a peer was about to inherit, shuffling
            # its wait into the tail. Displaced chips break ties.
            def _fallback_rank(candidate):
                displaced, count, name, _, victims = candidate
                end = podutil.latest_expected_end(victims, now)
                wait = float("inf") if end is None else end - now
                return (-wait, displaced, count, name)

            for _, _, name, drained, victims in sorted(
                candidates, key=_fallback_rank
            ):
                if not victims or not all(
                    podutil.is_checkpointable(v) for v in victims
                ):
                    continue
                eligible_at = max(
                    (self._victim_eligible_at(v, now) for v in victims),
                    default=now,
                )
                if eligible_at > now:
                    # Churn budget/cooldown blocks this drain for now; note
                    # when it unblocks so the no-op resync gate retries then
                    # (budget expiry is time-driven — no write announces it).
                    blocked_until.append(eligible_at)
                    continue
                plan = PartitioningPlan(state={name: drained.partitioning()})
                logger.info(
                    "consolidation (checkpoint): draining %s (%d checkpointable "
                    "victims, no rebind proof) to host %s",
                    name,
                    len(victims),
                    pod.metadata.namespaced_name,
                )
                for victim in victims:
                    self._note_checkpoint_eviction(victim, now)
                    self._evict(victim)
                self.actuator.apply(plan)
                from nos_tpu_torch.observability import metrics

                metrics.inc(
                    "nos_tpu_consolidations", kind=f"{self.kind}-checkpoint"
                )
                return True
            if blocked_until:
                retry_at = min(blocked_until)
                if self._age_gate_at is None or retry_at < self._age_gate_at:
                    self._age_gate_at = retry_at
        return False

    # -- checkpoint-eviction churn bookkeeping -------------------------------
    def _victim_eligible_at(self, victim: Pod, now: float) -> float:
        """Earliest time this workload may be fallback-evicted again
        (util/churn.ChurnLedger: cooldown + sliding-window budget)."""
        return self._churn.eligible_at(victim.metadata.namespaced_name, now)

    def _note_checkpoint_eviction(self, victim: Pod, now: float) -> None:
        self._churn.note(victim.metadata.namespaced_name, now)

    def _movable(self, spec, victim: Pod, preemptor: Pod) -> bool:
        """A victim is movable when it holds TPU capacity the carve needs,
        does not outrank the preemptor, and is not part of a gang (multi-host
        membership is the GroupPartitioner's domain)."""
        if victim.metadata.deletion_timestamp is not None:
            return False
        if victim.spec.priority > preemptor.spec.priority:
            return False
        if podutil.gang_of(victim) is not None:
            return False
        req = compute_pod_request(victim)
        return req.get(constants.RESOURCE_TPU, 0.0) > 0 or any(
            v > 0 and spec.is_slice_resource(k) for k, v in req.items()
        )

    def _drain_plan(self, spec, node, pod: Pod, victims: List[Pod], lacking: dict):
        """Full drain first; then reprieve victims (largest displaced work
        first) that the carve can spare — the preemption reprieve loop
        (capacity_scheduling.go:610-673) transplanted to geometry."""

        def try_drain(victim_set: List[Pod]):
            drained = node.clone()
            try:
                # Batched: pin release is only exact when a profile's in-use
                # slices are freed in full (see TpuNode.evict_pods).
                drained.evict_pods(victim_set)
            except (ValueError, KeyError):
                return None
            # May be a no-op when eviction alone frees an already-carved
            # slice of the right shape — schedulability is the real gate.
            drained.update_geometry_for(dict(lacking))
            if not self.planner.can_schedule(pod, drained):
                return None
            return drained

        drained = try_drain(victims)
        if drained is None:
            return None
        kept = list(victims)
        for v in sorted(
            victims,
            key=lambda p: -self._tpu_chips(spec, compute_pod_request(p)),
        ):
            spared = [w for w in kept if w is not v]
            if not spared:
                continue  # an empty eviction set means no consolidation at all
            trial = try_drain(spared)
            if trial is not None:
                kept = spared
                drained = trial
        if not kept:
            return None  # nothing to evict means the normal planner suffices
        return drained, kept

    def _victims_fit_elsewhere(self, snapshot, drained_name: str, victims: List[Pod]):
        """Every victim must provably rebind into the OTHER nodes' capacity
        right now (carving allowed) — this is what makes consolidation a
        migration rather than a preemption cascade. Returns the re-carved
        nodes the proof relied on ({} when none were needed), or None when
        some victim cannot rebind."""
        spec = snapshot.slice_spec
        others = {
            n: node.clone() for n, node in snapshot.nodes.items() if n != drained_name
        }
        carved: dict = {}
        for victim in sorted(
            victims,
            key=lambda p: -self._tpu_chips(spec, compute_pod_request(p)),
        ):
            vcopy = victim.deepcopy()
            vcopy.spec.node_name = ""
            vcopy.status.nominated_node_name = ""
            placed = False
            for name in sorted(others):
                node = others[name]
                if self.planner.can_schedule(vcopy, node):
                    node.add_pod(vcopy)
                    placed = True
                    break
                trial = node.clone()
                if trial.update_geometry_for(
                    dict(spec.pod_slice_request(vcopy))
                ) and self.planner.can_schedule(vcopy, trial):
                    trial.add_pod(vcopy)
                    others[name] = trial
                    carved[name] = trial
                    placed = True
                    break
            if not placed:
                return None
        return carved

    def _evict(self, victim: Pod) -> None:
        """Eviction = deletion; the workload controller resubmits
        (scheduler._evict semantics)."""
        from nos_tpu_torch.cluster.client import NotFoundError

        try:
            self.cluster.delete("Pod", victim.metadata.namespace, victim.metadata.name)
        except NotFoundError:
            pass

    def _resync_due(self) -> bool:
        """The reference requeues its reconcile every 10s while pods stay
        pending (partitioner_controller.go RequeueAfter); the scheduler stamps
        the Unschedulable condition only on transition, so long-pending pods
        produce no fresh watch events — the periodic resync re-plans for them
        once capacity or demand has shifted."""
        if self.resync_s <= 0:
            return False
        return (self._mono() - self._last_cycle_at) >= self.resync_s

    def fetch_pending_pods(self) -> List[Pod]:
        """Re-list pending pods at plan time — the batch only signals *when*
        to plan; the fresh list is the source of truth
        (partitioner_controller.go fetchPendingPods:202-210)."""
        return self.cluster.list(
            "Pod",
            predicate=podutil.extra_resources_could_help_scheduling,
        )

    def _current_partitioning(self, node_name: str) -> NodePartitioning:
        node = self.state.get_node(node_name)
        if node is None:
            return {}
        specs = ann.parse_spec(node.metadata.annotations)
        out: NodePartitioning = {}
        for s in specs:
            out.setdefault(s.device_index, {})[s.profile] = s.quantity
        return out

    # -- threaded runtime ----------------------------------------------------
    def run(self, poll_s: float = 0.5) -> None:
        while not self._stop.is_set():
            self.process_batch_if_ready()
            self._stop.wait(poll_s)
