"""Port of `nos_tpu/api/objects.py` (:1-271): `ObjectMeta` (:25), `PodPhase`
(:52), `Container` (:61), `OwnerReference` (:67), `PodCondition` (:77),
`PodSpec` (:84), `PodStatus` (:95), `Pod` (:102), .... Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

Core cluster object model: ObjectMeta, Pod, Node, ConfigMap.

A deliberately small, typed mirror of the k8s objects the reference manipulates
(it consumes them via client-go; we model just the fields the planner, scheduler
and controllers touch). Value semantics: the in-memory cluster deep-copies on
store/read, like an API server.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nos_tpu_torch.api.resources import ResourceList

_uid_counter = itertools.count(1)


def _next_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_next_uid)
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    def deepcopy(self) -> "ObjectMeta":
        return ObjectMeta(
            name=self.name,
            namespace=self.namespace,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            uid=self.uid,
            resource_version=self.resource_version,
            creation_timestamp=self.creation_timestamp,
            deletion_timestamp=self.deletion_timestamp,
        )


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class Container:
    name: str = "main"
    resources: ResourceList = field(default_factory=ResourceList)


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    # Required by a real API server's ValidateOwnerReferences; defaulted on
    # the wire (serialize.py) when unset so emulator-only callers stay terse.
    api_version: str = ""
    uid: str = ""


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: int = 0
    overhead: ResourceList = field(default_factory=ResourceList)
    node_selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class PodStatus:
    phase: str = PodPhase.PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    owner_references: List[OwnerReference] = field(default_factory=list)

    KIND = "Pod"

    def deepcopy(self) -> "Pod":
        # Hand-rolled: the in-memory cluster copies on every store/read (API
        # server value semantics) and generic copy.deepcopy dominated control
        # rounds end to end under load.
        return Pod(
            metadata=self.metadata.deepcopy(),
            spec=PodSpec(
                containers=[
                    Container(c.name, ResourceList(c.resources))
                    for c in self.spec.containers
                ],
                init_containers=[
                    Container(c.name, ResourceList(c.resources))
                    for c in self.spec.init_containers
                ],
                node_name=self.spec.node_name,
                scheduler_name=self.spec.scheduler_name,
                priority=self.spec.priority,
                overhead=ResourceList(self.spec.overhead),
                node_selector=dict(self.spec.node_selector),
            ),
            status=PodStatus(
                phase=self.status.phase,
                conditions=[
                    PodCondition(c.type, c.status, c.reason)
                    for c in self.status.conditions
                ],
                nominated_node_name=self.status.nominated_node_name,
            ),
            owner_references=[
                OwnerReference(o.kind, o.name, o.api_version, o.uid)
                for o in self.owner_references
            ],
        )

    def condition(self, ctype: str) -> Optional[PodCondition]:
        for c in self.status.conditions:
            if c.type == ctype:
                return c
        return None


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=ResourceList)
    allocatable: ResourceList = field(default_factory=ResourceList)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"

    def deepcopy(self) -> "Node":
        return Node(
            metadata=self.metadata.deepcopy(),
            status=NodeStatus(
                capacity=ResourceList(self.status.capacity),
                allocatable=ResourceList(self.status.allocatable),
            ),
        )


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    KIND = "ConfigMap"

    def deepcopy(self) -> "ConfigMap":
        return ConfigMap(metadata=self.metadata.deepcopy(), data=dict(self.data))


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 Lease spec — the leader-election lock object
    (controller-runtime managers hold one per component; SURVEY §5 config
    system: leader election)."""

    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)

    KIND = "Lease"

    def deepcopy(self) -> "Lease":
        return Lease(
            metadata=self.metadata.deepcopy(),
            spec=LeaseSpec(
                holder_identity=self.spec.holder_identity,
                lease_duration_seconds=self.spec.lease_duration_seconds,
                acquire_time=self.spec.acquire_time,
                renew_time=self.spec.renew_time,
                lease_transitions=self.spec.lease_transitions,
            ),
        )


@dataclass
class PodDisruptionBudgetSpec:
    """Exactly one of min_available / max_unavailable is meaningful (k8s
    policy/v1 semantics); selector matches pod labels within the namespace."""

    selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    """The preemption reprieve loop consults these: evicting a victim whose
    budget is exhausted counts as a PDB violation, and candidate nodes are
    ranked fewest-violations-first (the vendored preemption.Evaluator the
    reference runs in PostFilter, capacity_scheduling.go:323-341)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)

    KIND = "PodDisruptionBudget"

    def deepcopy(self) -> "PodDisruptionBudget":
        return PodDisruptionBudget(
            metadata=self.metadata.deepcopy(),
            spec=PodDisruptionBudgetSpec(
                selector=dict(self.spec.selector),
                min_available=self.spec.min_available,
                max_unavailable=self.spec.max_unavailable,
            ),
            status=PodDisruptionBudgetStatus(
                disruptions_allowed=self.status.disruptions_allowed,
                current_healthy=self.status.current_healthy,
                desired_healthy=self.status.desired_healthy,
                expected_pods=self.status.expected_pods,
            ),
        )

    def matches(self, pod: Pod) -> bool:
        # policy/v1 semantics: an empty selector selects every pod in the
        # namespace.
        return pod.metadata.namespace == self.metadata.namespace and all(
            pod.metadata.labels.get(k) == v for k, v in self.spec.selector.items()
        )
