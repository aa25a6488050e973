"""Port of `nos_tpu/scheduler/framework.py:1` (:1-198): `Code` (:23), `Status`
(:30), `CycleState` (:54), `Plugin` (:58), `PreFilterPlugin` (:62),
`FilterPlugin` (:75), `ScorePlugin` (:80), `ReservePlugin` (:85),
`PostFilterPlugin` (:93), `Framework` (:101). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

Scheduling plugin framework.

A compact, typed mirror of the kube-scheduler framework surface the reference
builds against (PreFilter / Filter / Score / Reserve / PostFilter + CycleState,
nominated-pod aware filtering) — the same framework runs standalone in the
scheduler *and* embedded in the partitioner's planning simulation
(cmd/gpupartitioner/gpupartitioner.go:293-317 analog).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.partitioning.core.interface import NodeInfo

logger = logging.getLogger(__name__)


class Code:
    SUCCESS = "Success"
    UNSCHEDULABLE = "Unschedulable"
    ERROR = "Error"


@dataclass
class Status:
    code: str = Code.SUCCESS
    reasons: List[str] = field(default_factory=list)

    @classmethod
    def success(cls) -> "Status":
        return cls()

    @classmethod
    def unschedulable(cls, *reasons: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, list(reasons))

    @classmethod
    def error(cls, *reasons: str) -> "Status":
        return cls(Code.ERROR, list(reasons))

    @property
    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def message(self) -> str:
        return "; ".join(self.reasons)


class CycleState(dict):
    """Per-scheduling-cycle scratch space shared between plugins."""


class Plugin:
    name = "Plugin"


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        return Status.success()

    # Preemption what-if extensions (AddPod/RemovePod,
    # capacity_scheduling.go:286-321).
    def add_pod(self, state: CycleState, pod: Pod, to_add: Pod, node: NodeInfo) -> None:
        pass

    def remove_pod(self, state: CycleState, pod: Pod, to_remove: Pod, node: NodeInfo) -> None:
        pass


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        return Status.success()


class ScorePlugin(Plugin):
    def score(self, state: CycleState, pod: Pod, node: NodeInfo) -> float:
        return 0.0


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        pass


class PostFilterPlugin(Plugin):
    def post_filter(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Tuple[Optional[str], Status]:
        """Return (nominated node, status) — preemption lives here."""
        return None, Status.unschedulable("no post-filter action")


class Framework:
    """Runs the plugin pipeline. `request_fn` computes a pod's effective
    request (the ResourceCalculator hook)."""

    def __init__(
        self,
        pre_filters: Optional[List[PreFilterPlugin]] = None,
        filters: Optional[List[FilterPlugin]] = None,
        scores: Optional[List[ScorePlugin]] = None,
        reserves: Optional[List[ReservePlugin]] = None,
        post_filters: Optional[List[PostFilterPlugin]] = None,
        request_fn: Optional[Callable[[Pod], ResourceList]] = None,
    ):
        from nos_tpu_torch.api.resources import compute_pod_request

        self.pre_filters = pre_filters or []
        self.filters = filters or []
        self.scores = scores or []
        self.reserves = reserves or []
        self.post_filters = post_filters or []
        self.request_fn = request_fn or compute_pod_request

    # -- pipeline stages -----------------------------------------------------
    def run_pre_filter(self, state: CycleState, pod: Pod) -> Status:
        for plugin in self.pre_filters:
            status = plugin.pre_filter(state, pod)
            if not status.is_success:
                return status
        return Status.success()

    def run_filters(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        for plugin in self.filters:
            status = plugin.filter(state, pod, node)
            if not status.is_success:
                return status
        return Status.success()

    def run_filters_with_nominated_pods(
        self,
        state: CycleState,
        pod: Pod,
        node: NodeInfo,
        nominated: List[Pod],
    ) -> Status:
        """Filter assuming >=-priority nominated pods already landed on the
        node (framework's RunFilterPluginsWithNominatedPods semantics)."""
        relevant = [
            p
            for p in nominated
            if p.status.nominated_node_name == node.name
            and p.spec.priority >= pod.spec.priority
            and p.metadata.namespaced_name != pod.metadata.namespaced_name
        ]
        if relevant:
            node = NodeInfo(
                name=node.name,
                labels=dict(node.labels),
                allocatable=ResourceList(node.allocatable),
                requested=ResourceList(node.requested),
                pods=list(node.pods),
            )
            for p in relevant:
                node.add_pod(p, self.request_fn(p))
                for plugin in self.pre_filters:
                    plugin.add_pod(state, pod, p, node)
        status = self.run_filters(state, pod, node)
        # Roll back what-if additions to plugin state.
        for p in relevant:
            for plugin in self.pre_filters:
                plugin.remove_pod(state, pod, p, node)
        return status

    def run_scores(self, state: CycleState, pod: Pod, node: NodeInfo) -> float:
        return sum(plugin.score(state, pod, node) for plugin in self.scores)

    def run_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        done: List[ReservePlugin] = []
        for plugin in self.reserves:
            status = plugin.reserve(state, pod, node_name)
            if not status.is_success:
                for p in reversed(done):
                    p.unreserve(state, pod, node_name)
                return status
            done.append(plugin)
        return Status.success()

    def run_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for plugin in reversed(self.reserves):
            plugin.unreserve(state, pod, node_name)

    def run_post_filters(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Tuple[Optional[str], Status]:
        for plugin in self.post_filters:
            nominated, status = plugin.post_filter(state, pod, nodes)
            if status.is_success or nominated:
                return nominated, status
        return None, Status.unschedulable("preemption found no candidates")
