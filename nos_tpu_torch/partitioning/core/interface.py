"""Port of `nos_tpu/partitioning/core/interface.py:1` (:1-142):
`partitioning_equal` (:24), `NodeInfo` (:38), `PartitionableNode` (:57),
`SliceSpec` (:84), `SnapshotTaker` (:99), `Partitioner` (:107),
`SimScheduler` (:116), `FitSimScheduler` (:130). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

Mode-agnostic engine contracts.

Analog of internal/partitioning/core/interface.go:27-73. A *mode* (tpu, mig,
mps) supplies: a SnapshotTaker that builds PartitionableNodes from cluster
state, a SliceSpec describing which extended resources are fractional slices,
and a Partitioner that actuates a planned geometry onto the cluster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Protocol, runtime_checkable

from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import ResourceList

# Desired partitioning of one node: device index -> {profile name -> quantity}
# (reference state/partitioning.go NodePartitioning/GPUPartitioning:24-56).
NodePartitioning = Dict[int, Dict[str, int]]
# Desired state of the cluster: node name -> NodePartitioning.
PartitioningState = Dict[str, NodePartitioning]


def partitioning_equal(a: NodePartitioning, b: NodePartitioning) -> bool:
    """Order-insensitive, zero-insensitive equality (partitioning.go:44-56)."""

    def clean(np: NodePartitioning):
        return {
            idx: {p: q for p, q in profs.items() if q > 0}
            for idx, profs in np.items()
            if any(q > 0 for q in profs.values())
        }

    return clean(a) == clean(b)


@dataclass
class NodeInfo:
    """The scheduler-visible view of a node (framework.NodeInfo analog)."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=ResourceList)
    requested: ResourceList = field(default_factory=ResourceList)
    pods: List[Pod] = field(default_factory=list)

    @property
    def free(self) -> ResourceList:
        return self.allocatable.subtract_non_negative(self.requested)

    def add_pod(self, pod: Pod, request: ResourceList) -> None:
        self.pods.append(pod)
        self.requested = self.requested.add(request)


@runtime_checkable
class PartitionableNode(Protocol):
    """A node whose device geometry the planner may mutate
    (core/interface.go PartitionableNode)."""

    @property
    def name(self) -> str: ...

    def update_geometry_for(self, lacking: Mapping[str, float]) -> bool:
        """Re-carve free devices to (partially) satisfy `lacking`
        (resource name -> missing quantity). True iff geometry changed."""
        ...

    def partitioning(self) -> NodePartitioning:
        """Current geometry as desired-state format."""
        ...

    def node_info(self) -> NodeInfo:
        """Scheduler view reflecting the *current* (possibly updated) geometry."""
        ...

    def add_pod(self, pod: Pod) -> None: ...

    def has_free_capacity(self) -> bool: ...

    def clone(self) -> "PartitionableNode": ...


class SliceSpec(Protocol):
    """Which resources are fractional device slices, and their relative size
    (reference SliceCalculator/SliceFilter, mig/slice_calculator.go:30-37)."""

    def is_slice_resource(self, resource_name: str) -> bool: ...

    def slice_weight(self, resource_name: str) -> float:
        """Relative size of one slice (chips or GB) — pod-sorting key."""
        ...

    def pod_slice_request(self, pod: Pod) -> ResourceList:
        """The pod's requested slice resources only."""
        ...


class SnapshotTaker(Protocol):
    """Builds a Snapshot of partitionable nodes from cluster state
    (mig/snapshot_taker.go:31-53 analog)."""

    def take_snapshot(self, cluster_state) -> "Snapshot":  # noqa: F821
        ...


class Partitioner(Protocol):
    """Applies one node's planned partitioning to the cluster
    (core/interface.go Partitioner.ApplyPartitioning)."""

    def apply_partitioning(
        self, node_name: str, plan_id: str, partitioning: NodePartitioning
    ) -> None: ...


class SimScheduler(Protocol):
    """Scheduling-simulation seam used by the planner to validate that a pod
    would actually schedule onto a candidate geometry (the embedded
    kube-scheduler framework in the reference, planner.go:174-203)."""

    def pre_filter(self, pod: Pod) -> bool:
        """Cluster-level admission (quota etc.); False = pod can't schedule."""
        ...

    def filter(self, pod: Pod, node: NodeInfo) -> bool:
        """Node-level feasibility for the pod."""
        ...


class FitSimScheduler:
    """Default SimScheduler: NodeResourcesFit + node-selector semantics.
    The full plugin framework (M5) satisfies the same protocol."""

    def pre_filter(self, pod: Pod) -> bool:
        return True

    def filter(self, pod: Pod, node: NodeInfo) -> bool:
        from nos_tpu_torch.api.resources import compute_pod_request

        if any(node.labels.get(k) != v for k, v in pod.spec.node_selector.items()):
            return False
        return compute_pod_request(pod).fits_in(node.free)
