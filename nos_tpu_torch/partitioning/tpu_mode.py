"""Port of `nos_tpu/partitioning/tpu_mode.py:1` (:1-293): `TpuSliceSpec` (:23),
`TpuNode` (:40), `TpuPartitioner` (:230), `TpuSnapshotTaker` (:256). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

TPU partitioning mode: slice spec, partitionable node, snapshot taker.

The TPU analog of internal/partitioning/mig/{slice_calculator.go, slice_filter.go,
snapshot_taker.go} + pkg/gpu/mig/node.go. One k8s node owns one ICI chip mesh
(device index 0); its geometry is the multiset of carved sub-slices, reported
via the status annotations and re-carved by the planner through TpuMesh.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api import annotations as ann
from nos_tpu_torch.api.objects import Node, Pod
from nos_tpu_torch.api.resources import ResourceList, compute_pod_request
from nos_tpu_torch.partitioning.core.interface import NodeInfo, NodePartitioning
from nos_tpu_torch.tpu import Profile, Topology, TpuMesh

TPU_DEVICE_INDEX = 0  # one mesh per node


class TpuSliceSpec:
    """SliceSpec for google.com/tpu-<shape> resources."""

    def is_slice_resource(self, resource_name: str) -> bool:
        return bool(constants.RESOURCE_TPU_SLICE_REGEX.match(resource_name))

    def slice_weight(self, resource_name: str) -> float:
        profile = Profile.from_resource(resource_name)
        return float(profile.chips) if profile else 0.0

    def pod_slice_request(self, pod: Pod) -> ResourceList:
        req = compute_pod_request(pod)
        return ResourceList(
            {k: v for k, v in req.items() if v > 0 and self.is_slice_resource(k)}
        )


class TpuNode:
    """PartitionableNode over one node's TpuMesh (pkg/gpu/mig/node.go analog)."""

    def __init__(
        self,
        name: str,
        mesh: TpuMesh,
        labels: Optional[Dict[str, str]] = None,
        base_allocatable: Optional[ResourceList] = None,
        requested: Optional[ResourceList] = None,
        pods: Optional[List[Pod]] = None,
    ):
        self._name = name
        self.mesh = mesh
        self.labels = dict(labels or {})
        # Non-TPU resources (cpu, memory, ...) from node.status.allocatable.
        self.base_allocatable = ResourceList(
            {
                k: v
                for k, v in (base_allocatable or ResourceList()).items()
                if k != constants.RESOURCE_TPU
                and not constants.RESOURCE_TPU_SLICE_REGEX.match(k)
            }
        )
        self.requested = ResourceList(requested or {})
        self.pods: List[Pod] = list(pods or [])

    # -- construction from cluster objects ---------------------------------
    @classmethod
    def from_node(
        cls,
        node: Node,
        pods: Optional[List[Pod]] = None,
        requested: Optional[ResourceList] = None,
    ) -> "TpuNode":
        """Build from GKE discovery labels + status annotations
        (mig/node.go:40-104 analog: status annotations are the source of truth
        for the current geometry)."""
        topology = Topology.from_node_labels(node.metadata.labels)
        if topology is None:
            raise ValueError(f"node {node.metadata.name} has no TPU topology labels")
        statuses = ann.parse_status(node.metadata.annotations)
        geometry: Dict[Profile, int] = {}
        used: Dict[Profile, int] = {}
        for idx, profs in ann.geometry_counts_from_status(statuses).items():
            if idx != TPU_DEVICE_INDEX:
                continue
            for prof_name, (free, in_use) in profs.items():
                profile = Profile.parse(prof_name)
                total = free + in_use
                if total > 0:
                    geometry[profile] = total
                if in_use > 0:
                    used[profile] = in_use
        # Pin the physical placement of in-use slices (layout annotation):
        # re-carving must pack around them, not assume a blank mesh — ICI
        # placement is the graph constraint the counts model can't see.
        layout = ann.get_layout(node.metadata.annotations)
        pinned = [(e.origin, e.dims) for e in layout if e.used] if layout else None
        mesh = TpuMesh(topology, geometry, used, pinned=pinned)
        if requested is None:
            requested = ResourceList()
            for p in pods or []:
                requested = requested.add(compute_pod_request(p))
        return cls(
            name=node.metadata.name,
            mesh=mesh,
            labels=node.metadata.labels,
            base_allocatable=node.status.allocatable,
            requested=requested,
            pods=pods,
        )

    # -- PartitionableNode protocol -----------------------------------------
    @property
    def name(self) -> str:
        return self._name

    def update_geometry_for(self, lacking: Mapping[str, float]) -> bool:
        required: Dict[Profile, int] = {}
        for resource_name, qty in lacking.items():
            profile = Profile.from_resource(resource_name)
            if profile is not None and qty > 0:
                required[profile] = required.get(profile, 0) + int(round(qty))
        # Chips held by whole-chip pods must survive the re-carve.
        reserved = int(round(self.requested.get(constants.RESOURCE_TPU, 0.0)))
        return self.mesh.update_geometry_for(required, reserved_chips=reserved)

    def partitioning(self) -> NodePartitioning:
        return {
            TPU_DEVICE_INDEX: {p.name: n for p, n in sorted(self.mesh.geometry.items())}
        }

    def node_info(self) -> NodeInfo:
        allocatable = ResourceList(self.base_allocatable)
        # Uncarved chips stay whole-chip schedulable; carved capacity is
        # exposed as slice resources (mig/node.go:172-195 recompute analog).
        allocatable[constants.RESOURCE_TPU] = float(self.mesh.free_chips)
        for resource, count in self.mesh.as_resources().items():
            allocatable[resource] = float(count)
        # Device-layer used counts are authoritative even when the pod cache
        # lags (agent-reported status is the source of truth, util.go:75-89).
        requested = ResourceList(self.requested)
        for profile, n in self.mesh.used.items():
            requested[profile.resource] = max(requested.get(profile.resource, 0.0), float(n))
        return NodeInfo(
            name=self._name,
            labels=dict(self.labels),
            allocatable=allocatable,
            requested=requested,
            pods=list(self.pods),
        )

    def add_pod(self, pod: Pod) -> None:
        request = compute_pod_request(pod)
        for resource_name, qty in request.items():
            profile = Profile.from_resource(resource_name)
            if profile is not None and qty > 0:
                self.mesh.mark_used(profile, int(round(qty)))
        self.pods.append(pod)
        self.requested = self.requested.add(request)

    def reserve_capacity(self, request: ResourceList) -> None:
        """Claim capacity for an in-flight migration destination: the slice
        the actuator created for the mover must read as USED to every
        concurrent replan until the mover rebinds, or the planner would
        reshape it / hand it to another pod (the double-claim race). Marks
        the slice in-use on the mesh when it already exists; either way the
        request lands in `requested` so plain resource fit blocks it too.
        Conservative by design: if the agent has not created the slice yet,
        the reservation still subtracts from the node's schedulable free."""
        for resource_name, qty in request.items():
            profile = Profile.from_resource(resource_name)
            if profile is not None and qty > 0:
                try:
                    self.mesh.mark_used(profile, int(round(qty)))
                except (ValueError, KeyError):
                    pass  # slice not materialized yet: requested covers it
        self.requested = self.requested.add(request)

    def evict_pods(self, pods: List[Pod]) -> None:
        """What-if removal of bound pods: release their slices (and pinned
        placements) so a consolidation re-carve can plan through the freed
        region. Batched so per-profile counts aggregate: pins carry no pod
        identity, and TpuMesh.release only unpins when a profile's in-use
        slices are released IN FULL — a partial release stays used+pinned
        (conservative: the model under-frees, never certifies a carve the
        agent would refuse). The presence of this hook marks a node type as
        consolidation-capable (the controller checks for it)."""
        per_profile: Dict[Profile, int] = {}
        total = ResourceList()
        names = set()
        for pod in pods:
            request = compute_pod_request(pod)
            total = total.add(request)
            names.add(pod.metadata.namespaced_name)
            for resource_name, qty in request.items():
                profile = Profile.from_resource(resource_name)
                if profile is not None and qty > 0:
                    per_profile[profile] = per_profile.get(profile, 0) + int(round(qty))
        for profile, count in per_profile.items():
            self.mesh.release(profile, count)
        self.pods = [p for p in self.pods if p.metadata.namespaced_name not in names]
        self.requested = self.requested.subtract(total).non_zero()

    def evict_pod(self, pod: Pod) -> None:
        self.evict_pods([pod])

    def has_free_capacity(self) -> bool:
        return self.mesh.has_free_capacity()

    def free_capacity_units(self) -> float:
        """Chips not pinned by running work: uncarved chips plus free carved
        slices (the best-fit ordering key in Snapshot.get_candidate_nodes)."""
        return float(
            self.mesh.free_chips
            + sum(p.chips * n for p, n in self.mesh.free.items())
        )

    def clone(self) -> "TpuNode":
        return TpuNode(
            name=self._name,
            mesh=self.mesh.clone(),
            labels=dict(self.labels),
            base_allocatable=ResourceList(self.base_allocatable),
            requested=ResourceList(self.requested),
            pods=list(self.pods),
        )


class TpuPartitioner:
    """Actuation channel: write the planned geometry as spec annotations on the
    node plus the plan id (mig/partitioner.go:43-75 analog). The node agent
    picks it up from its node watch."""

    def __init__(self, cluster):
        self._cluster = cluster

    def apply_partitioning(
        self, node_name: str, plan_id: str, partitioning: NodePartitioning
    ) -> None:
        def mutate(node: Node) -> None:
            ann.strip_spec_annotations(node.metadata.annotations)
            specs = []
            for device_index, profiles in partitioning.items():
                specs.extend(
                    ann.SpecAnnotation(device_index, prof, qty)
                    for prof, qty in profiles.items()
                    if qty > 0
                )
            node.metadata.annotations.update(ann.format_spec(specs))
            node.metadata.annotations[constants.ANNOTATION_SPEC_PLAN] = plan_id

        self._cluster.patch("Node", "", node_name, mutate)


class TpuSnapshotTaker:
    """Builds a Snapshot of TPU-mode nodes from ClusterState
    (mig/snapshot_taker.go:31-53 analog)."""

    def __init__(self):
        self.slice_spec = TpuSliceSpec()

    def take_snapshot(self, cluster_state):
        from nos_tpu_torch.partitioning.core.snapshot import Snapshot

        from nos_tpu_torch.controllers.health import is_node_device_healthy

        nodes = {}
        for node in cluster_state.nodes(
            label_selector={constants.LABEL_PARTITIONING: constants.KIND_TPU}
        ):
            if Topology.from_node_labels(node.metadata.labels) is None:
                continue
            if not is_node_device_healthy(node):
                continue  # never carve a node whose device layer is unhealthy
            name = node.metadata.name
            nodes[name] = TpuNode.from_node(
                node,
                pods=cluster_state.node_pods(name),
                requested=cluster_state.node_requested(name),
            )
        # In-flight migrations: reserve each mover's capacity on its
        # destination and remember the mover keys, so this plan neither
        # reshapes the reserved slice nor carves a duplicate for the
        # mover's resubmitted pod (state.MigrationNote).
        reserved_keys = set()
        for note in cluster_state.active_migrations():
            dest = nodes.get(note.dest_node)
            if dest is None:
                continue  # destination left the snapshot; note will expire
            dest.reserve_capacity(note.request)
            reserved_keys.add(note.pod_key)
        return Snapshot(nodes, self.slice_spec, reserved_pod_keys=reserved_keys)
