"""Port of `nos_tpu/scheduler/plugins/capacity.py:1` (:1-340):
`CapacityScheduling` (:43). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

CapacityScheduling: elastic-quota enforcement + fair-share preemption.

Analog of pkg/scheduler/plugins/capacityscheduling/capacity_scheduling.go:
  - PreFilter (:190-278): snapshot quota infos into CycleState; reject when
    used+request exceeds the namespace quota's max, or — when the pod would
    borrow beyond min — when aggregated used+request exceeds Σ min;
  - AddPod/RemovePod (:286-321): keep the snapshot honest during what-if;
  - Reserve/Unreserve (:343-369): commit/rollback into live usage;
  - PostFilter (:323-341, :468-675): preemption with elastic-quota fair
    sharing — a pod within its guaranteed min may preempt over-quota
    borrowers of other quotas above their min; a borrowing pod may preempt
    same-namespace lower-priority pods or borrowers exceeding their
    *guaranteed over-quota share* (GetGuaranteedOverquotas math), with a
    PDB-style reprieve loop re-admitting victims that turn out unnecessary.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod, PodDisruptionBudget, PodPhase
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.partitioning.core.interface import NodeInfo
from nos_tpu_torch.scheduler.framework import (
    CycleState,
    PostFilterPlugin,
    PreFilterPlugin,
    ReservePlugin,
    Status,
)
from nos_tpu_torch.scheduler.quota_info import ElasticQuotaInfos
from nos_tpu_torch.scheduler.resource_calculator import ResourceCalculator
from nos_tpu_torch.util import pod as podutil

logger = logging.getLogger(__name__)

STATE_SNAPSHOT = "capacity/snapshot"
STATE_REQUEST = "capacity/request"


class CapacityScheduling(PreFilterPlugin, ReservePlugin, PostFilterPlugin):
    name = "CapacityScheduling"

    def __init__(
        self,
        calculator: Optional[ResourceCalculator] = None,
        evict_fn: Optional[Callable[[Pod], None]] = None,
    ):
        self.calculator = calculator or ResourceCalculator()
        self.infos = ElasticQuotaInfos()
        self.evict_fn = evict_fn
        self.framework = None  # injected by the Scheduler for reprieve checks
        self.nominated_pods: List[Pod] = []
        self.pdbs: List[PodDisruptionBudget] = []

    # -- live state ----------------------------------------------------------
    def refresh_from_cluster(self, cluster) -> None:
        """Rebuild quota infos from CRDs; recompute used from active pods
        (the informer + Reserve bookkeeping of the reference, collapsed into a
        stateless recompute per scheduling pass)."""
        infos = ElasticQuotaInfos.from_objects(
            cluster.list("ElasticQuota"), cluster.list("CompositeElasticQuota")
        )
        for info in infos:
            info.used = ResourceList()
        active = []
        for pod in cluster.list("Pod"):
            if not podutil.is_active(pod):
                continue
            active.append(pod)
            info = infos.for_namespace(pod.metadata.namespace)
            if info is not None:
                info.add_used(self.calculator.compute_pod_request(pod))
        self.infos = infos
        self.pdbs = cluster.list("PodDisruptionBudget")
        for pdb in self.pdbs:
            # currentHealthy counts only ready pods: scheduled-but-Pending
            # pods must not inflate the disruption budget.
            healthy = sum(
                1
                for p in active
                if pdb.matches(p) and p.status.phase == PodPhase.RUNNING
            )
            if pdb.spec.min_available is not None:
                desired = pdb.spec.min_available
            elif pdb.spec.max_unavailable is not None:
                desired = max(0, healthy - pdb.spec.max_unavailable)
            else:
                desired = 0
            pdb.status.current_healthy = healthy
            pdb.status.desired_healthy = desired
            pdb.status.expected_pods = healthy
            pdb.status.disruptions_allowed = max(0, healthy - desired)

    # -- PreFilter -----------------------------------------------------------
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        request = self.calculator.compute_pod_request(pod)
        snapshot = self.infos.clone()
        state[STATE_REQUEST] = request
        state[STATE_SNAPSHOT] = snapshot
        info = snapshot.for_namespace(pod.metadata.namespace)
        if info is None:
            return Status.success()
        if not info.fits_max(request):
            return Status.unschedulable(
                f"pod would exceed ElasticQuota max of {info.name}"
            )
        if info.is_over_min_with(request):
            if not snapshot.aggregated_used_fits_total_min(info.metered(request)):
                return Status.unschedulable(
                    "insufficient unused guaranteed quota to borrow from"
                )
        return Status.success()

    def add_pod(self, state: CycleState, pod: Pod, to_add: Pod, node: NodeInfo) -> None:
        snapshot: ElasticQuotaInfos = state.get(STATE_SNAPSHOT)
        if snapshot is None:
            return
        info = snapshot.for_namespace(to_add.metadata.namespace)
        if info is not None:
            info.add_used(self.calculator.compute_pod_request(to_add))

    def remove_pod(self, state: CycleState, pod: Pod, to_remove: Pod, node: NodeInfo) -> None:
        snapshot: ElasticQuotaInfos = state.get(STATE_SNAPSHOT)
        if snapshot is None:
            return
        info = snapshot.for_namespace(to_remove.metadata.namespace)
        if info is not None:
            info.subtract_used(self.calculator.compute_pod_request(to_remove))

    # -- Reserve -------------------------------------------------------------
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        info = self.infos.for_namespace(pod.metadata.namespace)
        if info is not None:
            info.add_used(self.calculator.compute_pod_request(pod))
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        info = self.infos.for_namespace(pod.metadata.namespace)
        if info is not None:
            info.subtract_used(self.calculator.compute_pod_request(pod))

    # -- PostFilter: preemption ---------------------------------------------
    def post_filter(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Tuple[Optional[str], Status]:
        if not self._eligible_to_preempt(pod, nodes):
            return None, Status.unschedulable("pod not eligible to preempt")
        candidates: Dict[str, Tuple[List[Pod], int]] = {}
        for node in nodes:
            selected = self._select_victims_on_node(state, pod, node)
            if selected is not None:
                candidates[node.name] = selected
        if not candidates:
            return None, Status.unschedulable("preemption: no node yields victims")
        # Fewest PDB violations, then fewest victims, then lowest max victim
        # priority, then node name (preemption.Evaluator candidate ordering).
        def rank(item):
            name, (victims, violations) = item
            return (
                violations,
                len(victims),
                max((v.spec.priority for v in victims), default=0),
                name,
            )

        node_name, (victims, _) = min(candidates.items(), key=rank)
        for victim in victims:
            logger.info(
                "preempting %s to make room for %s on %s",
                victim.metadata.namespaced_name,
                pod.metadata.namespaced_name,
                node_name,
            )
            if self.evict_fn is not None:
                self.evict_fn(victim)
        return node_name, Status.success()

    def _eligible_to_preempt(self, pod: Pod, nodes: List[NodeInfo]) -> bool:
        """preemptor.PodEligibleToPreemptOthers analog (:394-466): a pod that
        nominated a node waits ONLY while lower-priority victims on it are
        still terminating. Once they are gone (eviction is immediate here),
        the pod may preempt again — otherwise two preemptors nominated onto
        the same node deadlock, each blocked by the other's assumed share
        while an over-quota victim keeps running."""
        nominated = pod.status.nominated_node_name
        if not nominated:
            return True
        for node in nodes:
            if node.name != nominated:
                continue
            for p in node.pods:
                if (
                    p.metadata.deletion_timestamp is not None
                    and p.spec.priority < pod.spec.priority
                ):
                    return False  # victims still terminating: keep waiting
        return True

    def _select_victims_on_node(
        self, state: CycleState, pod: Pod, node: NodeInfo
    ) -> Optional[Tuple[List[Pod], int]]:
        """SelectVictimsOnNode analog (:468-675). Returns (victims, number of
        PDB violations among them) or None."""
        request: ResourceList = state.get(STATE_REQUEST)
        base: ElasticQuotaInfos = state.get(STATE_SNAPSHOT)
        if request is None or base is None:
            return None
        snapshot = base.clone()
        preemptor_info = snapshot.for_namespace(pod.metadata.namespace)

        candidates: List[Pod] = []
        if preemptor_info is None:
            # No quota: plain priority preemption within the node.
            candidates = [
                p for p in node.pods if p.spec.priority < pod.spec.priority
            ]
        elif not preemptor_info.is_over_min_with(request):
            # Within guaranteed min: reclaim from over-quota borrowers whose
            # quota sits above its min (fair-sharing branch :546-565).
            for p in node.pods:
                if not podutil.is_over_quota(p):
                    continue
                v_info = snapshot.for_namespace(p.metadata.namespace)
                if v_info is None or v_info.name == preemptor_info.name:
                    continue
                if v_info.used_over_min():
                    candidates.append(p)
        else:
            # Borrowing preemptor: entitled only up to min + guaranteed share.
            guaranteed = snapshot.guaranteed_overquotas(preemptor_info.name)
            entitled = preemptor_info.min.add(guaranteed)
            if not preemptor_info.used.add(preemptor_info.metered(request)).fits_in(entitled):
                return None
            for p in node.pods:
                same_ns = p.metadata.namespace == pod.metadata.namespace
                if same_ns and p.spec.priority < pod.spec.priority:
                    candidates.append(p)
                    continue
                if not same_ns and podutil.is_over_quota(p):
                    v_info = snapshot.for_namespace(p.metadata.namespace)
                    if v_info is None or v_info.name == preemptor_info.name:
                        continue
                    v_guaranteed = snapshot.guaranteed_overquotas(v_info.name)
                    v_entitled = v_info.min.add(v_guaranteed)
                    if not v_info.used.fits_in(v_entitled):
                        candidates.append(p)
        if not candidates:
            return None

        # What-if: remove all candidates, check feasibility, then reprieve.
        sim = NodeInfo(
            name=node.name,
            labels=dict(node.labels),
            allocatable=ResourceList(node.allocatable),
            requested=ResourceList(node.requested),
            pods=list(node.pods),
        )
        for victim in candidates:
            self._sim_remove(sim, snapshot, victim)

        if not self._feasible(state, pod, sim, snapshot, request):
            return None

        # Split candidates by whether evicting them would violate a
        # PodDisruptionBudget (dynamic budget walk, preemption's
        # filterPodsWithPDBViolation), then reprieve — violating pods first so
        # they are spared whenever the pod fits without them, then the rest
        # highest priority first with over-quota borrowers last (:610-673).
        ordered = sorted(
            candidates, key=lambda p: (podutil.is_over_quota(p), -p.spec.priority)
        )
        budget = {pdb.metadata.uid: pdb.status.disruptions_allowed for pdb in self.pdbs}
        violating, non_violating = [], []
        for p in ordered:
            matching = [pdb for pdb in self.pdbs if pdb.matches(p)]
            if any(budget[pdb.metadata.uid] <= 0 for pdb in matching):
                violating.append(p)
                continue
            for pdb in matching:
                budget[pdb.metadata.uid] -= 1
            non_violating.append(p)

        victims: List[Pod] = []
        violations = 0
        for victim in violating + non_violating:
            self._sim_add(sim, snapshot, victim)
            if self._feasible(state, pod, sim, snapshot, request):
                continue  # victim reprieved
            self._sim_remove(sim, snapshot, victim)
            victims.append(victim)
            if victim in violating:
                violations += 1
        if not victims:
            return None
        return victims, violations

    # -- helpers -------------------------------------------------------------
    def _sim_remove(self, sim: NodeInfo, snapshot: ElasticQuotaInfos, victim: Pod) -> None:
        req = self.calculator.compute_pod_request(victim)
        sim.pods = [
            p
            for p in sim.pods
            if p.metadata.namespaced_name != victim.metadata.namespaced_name
        ]
        sim.requested = sim.requested.subtract(req).non_zero()
        info = snapshot.for_namespace(victim.metadata.namespace)
        if info is not None:
            info.subtract_used(req)

    def _sim_add(self, sim: NodeInfo, snapshot: ElasticQuotaInfos, victim: Pod) -> None:
        req = self.calculator.compute_pod_request(victim)
        sim.add_pod(victim, req)
        info = snapshot.for_namespace(victim.metadata.namespace)
        if info is not None:
            info.add_used(req)

    def _feasible(
        self,
        state: CycleState,
        pod: Pod,
        sim: NodeInfo,
        snapshot: ElasticQuotaInfos,
        request: ResourceList,
    ) -> bool:
        # Quota feasibility against the what-if snapshot.
        info = snapshot.for_namespace(pod.metadata.namespace)
        if info is not None:
            if not info.fits_max(request):
                return False
            if info.is_over_min_with(request) and not snapshot.aggregated_used_fits_total_min(info.metered(request)):
                return False
        # Node feasibility through the framework's filters.
        if self.framework is not None:
            return self.framework.run_filters_with_nominated_pods(
                state, pod, sim, self.nominated_pods
            ).is_success
        return request.fits_in(sim.free)
