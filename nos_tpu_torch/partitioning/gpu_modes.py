"""Port of `nos_tpu/partitioning/gpu_modes.py:1` (:1-538): `MigSliceSpec`
(:33), `MpsSliceSpec` (:48), `GpuNode` (:66), `MigSnapshotTaker` (:262),
`MpsSnapshotTaker` (:320), `hybrid_contended_indexes` (:371),
`AnnotationPartitioner` (:391), `MigPartitioner` (:449), `MpsPartitioner`
(:454). Copied verbatim; only the imports point at the port, which imports
nothing of the JAX package.

MIG and MPS partitioning modes over multi-GPU nodes.

Analog of internal/partitioning/{mig,mps}: slice specs, PartitionableNodes
spanning several GPUs (device indexes in the annotation protocol), snapshot
takers keyed on the partitioning label + NVIDIA GFD discovery labels, and the
two actuation channels: MIG via spec annotations (mig/partitioner.go:43-75),
MPS via the device-plugin ConfigMap + node label flip
(mps/partitioner.go:61-157) — plus spec annotations for the plan handshake.
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Dict, List, Mapping, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api import annotations as ann
from nos_tpu_torch.api.objects import ConfigMap, Node, Pod
from nos_tpu_torch.api.resources import ResourceList, compute_pod_request
from nos_tpu_torch.cluster.client import Cluster, NotFoundError
from nos_tpu_torch.gpu.mig import MigGpu, MigProfile
from nos_tpu_torch.gpu.mig import model_known as mig_model_known
from nos_tpu_torch.gpu.mps import MpsGpu, MpsProfile
from nos_tpu_torch.partitioning.core.interface import NodeInfo, NodePartitioning

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Slice specs
# ---------------------------------------------------------------------------
class MigSliceSpec:
    def is_slice_resource(self, resource_name: str) -> bool:
        return bool(constants.RESOURCE_MIG_REGEX.match(resource_name))

    def slice_weight(self, resource_name: str) -> float:
        p = MigProfile.from_resource(resource_name)
        return float(p.memory_gb) if p else 0.0

    def pod_slice_request(self, pod: Pod) -> ResourceList:
        req = compute_pod_request(pod)
        return ResourceList(
            {k: v for k, v in req.items() if v > 0 and self.is_slice_resource(k)}
        )


class MpsSliceSpec:
    def is_slice_resource(self, resource_name: str) -> bool:
        return bool(constants.RESOURCE_MPS_REGEX.match(resource_name))

    def slice_weight(self, resource_name: str) -> float:
        p = MpsProfile.from_resource(resource_name)
        return float(p.memory_gb) if p else 0.0

    def pod_slice_request(self, pod: Pod) -> ResourceList:
        req = compute_pod_request(pod)
        return ResourceList(
            {k: v for k, v in req.items() if v > 0 and self.is_slice_resource(k)}
        )


# ---------------------------------------------------------------------------
# Multi-GPU partitionable node (shared shape for both modes)
# ---------------------------------------------------------------------------
class GpuNode:
    """PartitionableNode over a list of per-GPU device models
    (mig/node.go:40-195 and slicing/node.go:32-215 analog)."""

    def __init__(
        self,
        name: str,
        gpus: List,  # MigGpu | MpsGpu
        profile_parser: Callable[[str], Optional[object]],
        labels: Optional[Dict[str, str]] = None,
        base_allocatable: Optional[ResourceList] = None,
        requested: Optional[ResourceList] = None,
        pods: Optional[List[Pod]] = None,
    ):
        self._name = name
        self.gpus = gpus
        self._parse = profile_parser
        self.labels = dict(labels or {})
        self.base_allocatable = ResourceList(
            {
                k: v
                for k, v in (base_allocatable or ResourceList()).items()
                if not constants.RESOURCE_MIG_REGEX.match(k)
                and not constants.RESOURCE_MPS_REGEX.match(k)
                and k != constants.RESOURCE_NVIDIA_GPU
            }
        )
        self.requested = ResourceList(requested or {})
        self.pods: List[Pod] = list(pods or [])

    @property
    def name(self) -> str:
        return self._name

    def update_geometry_for(self, lacking: Mapping[str, float]) -> bool:
        required = {}
        for resource_name, qty in lacking.items():
            profile = self._parse(resource_name)
            if profile is not None and qty > 0:
                required[profile] = required.get(profile, 0) + int(round(qty))
        if not required:
            return False
        changed = False
        remaining = dict(required)
        for gpu in self.gpus:
            if not remaining:
                break
            if gpu.update_geometry_for(remaining):
                changed = True
                # Account for what this GPU now offers free.
                for profile, free_n in gpu.free.items():
                    if profile in remaining:
                        remaining[profile] = max(0, remaining[profile] - free_n)
                        if remaining[profile] == 0:
                            del remaining[profile]
        return changed

    def partitioning(self) -> NodePartitioning:
        return {
            gpu.index: {str(p): n for p, n in sorted(gpu.geometry.items())}
            for gpu in self.gpus
        }

    def node_info(self) -> NodeInfo:
        allocatable = ResourceList(self.base_allocatable)
        used_counts: Dict[str, float] = {}
        for gpu in self.gpus:
            for resource, count in gpu.as_resources().items():
                allocatable[resource] = allocatable.get(resource, 0.0) + float(count)
            for profile, n in gpu.used.items():
                res = profile.resource
                used_counts[res] = used_counts.get(res, 0.0) + float(n)
        # Device-layer used counts are authoritative even when the pod cache
        # lags (agent-reported status is the source of truth, util.go:75-89).
        requested = ResourceList(self.requested)
        for res, n in used_counts.items():
            requested[res] = max(requested.get(res, 0.0), n)
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
            profile = self._parse(resource_name)
            if profile is None or qty <= 0:
                continue
            need = int(round(qty))
            for gpu in self.gpus:
                while need > 0 and gpu.free.get(profile, 0) > 0:
                    gpu.mark_used(profile)
                    need -= 1
            if need > 0:
                raise ValueError(f"no free {profile} slices on {self._name}")
        self.pods.append(pod)
        self.requested = self.requested.add(request)

    def has_free_capacity(self) -> bool:
        return any(gpu.has_free_capacity() for gpu in self.gpus)

    def free_capacity_units(self) -> float:
        """Memory GB not pinned by running work — uncarved budget plus free
        carved slices (the best-fit ordering key; a fully-unpartitioned GPU
        counts its whole budget, so empty devices sort LAST and keep their
        large regions intact)."""
        return float(sum(gpu.free_capacity_gb() for gpu in self.gpus))

    def clone(self) -> "GpuNode":
        return GpuNode(
            name=self._name,
            gpus=[g.clone() for g in self.gpus],
            profile_parser=self._parse,
            labels=dict(self.labels),
            base_allocatable=ResourceList(self.base_allocatable),
            requested=ResourceList(self.requested),
            pods=list(self.pods),
        )


# ---------------------------------------------------------------------------
# Snapshot takers
# ---------------------------------------------------------------------------
def _gfd(node: Node):
    labels = node.metadata.labels
    model = labels.get(constants.LABEL_GPU_PRODUCT, "")
    count = int(labels.get(constants.LABEL_GPU_COUNT, "0") or 0)
    memory_mb = float(labels.get(constants.LABEL_GPU_MEMORY, "0") or 0)
    memory_gb = int(round(memory_mb / 1024)) if memory_mb > 256 else int(memory_mb)
    return model, count, memory_gb


def _node_status_geometry(node: Node, parse) -> Dict[int, Dict]:
    """device index -> (geometry, used) from status annotations. Profiles
    the parser rejects are skipped, not fatal: on a hybrid node the same
    annotation set carries BOTH modes' statuses, and each taker must read
    past the other mode's entries ("10gb" raises in MigProfile.parse and
    "1g.5gb" raises in MpsProfile.parse)."""
    out: Dict[int, Dict] = {}
    statuses = ann.parse_status(node.metadata.annotations)
    for idx, profs in ann.geometry_counts_from_status(statuses).items():
        geometry, used = {}, {}
        for prof_name, (free, in_use) in profs.items():
            try:
                profile = parse(prof_name)
            except ValueError:
                profile = None
            if profile is None:
                continue
            total = free + in_use
            if total > 0:
                geometry[profile] = total
            if in_use > 0:
                used[profile] = in_use
        out[idx] = {"geometry": geometry, "used": used}
    return out


def _parses_as(parse) -> Callable[[str], bool]:
    def accepts(profile_name: str) -> bool:
        try:
            parse(profile_name)
            return True
        except ValueError:
            return False

    return accepts


def _claimed_by_other_mode(node: Node, other_parse) -> set:
    """Device indexes on a hybrid node whose status (or pending spec) shows
    the OTHER mode's slices. Each GPU of a hybrid node is single-mode (MIG
    is a per-GPU hardware mode), so a taker must not offer those GPUs to its
    planner; an uncarved GPU stays eligible for both modes and the first
    plan to land claims it (the agent's hybrid validator arbitrates races,
    and the plan handshake re-syncs the loser's view)."""
    if node.metadata.labels.get(constants.LABEL_PARTITIONING) != constants.KIND_HYBRID:
        return set()
    claimed = set()
    entries = [
        (s.device_index, s.profile, s.quantity)
        for s in ann.parse_status(node.metadata.annotations)
    ] + [
        (s.device_index, s.profile, s.quantity)
        for s in ann.parse_spec(node.metadata.annotations)
    ]
    accepts = _parses_as(other_parse)
    for idx, prof_name, qty in entries:
        if qty > 0 and accepts(prof_name):
            claimed.add(idx)
    return claimed


class MigSnapshotTaker:
    def __init__(self):
        self.slice_spec = MigSliceSpec()

    def take_snapshot(self, cluster_state):
        from nos_tpu_torch.partitioning.core.snapshot import Snapshot

        from nos_tpu_torch.controllers.health import is_node_device_healthy

        nodes = {}
        for node in cluster_state.nodes(
            label_selector={
                constants.LABEL_PARTITIONING: constants.partitioning_label_values(
                    constants.KIND_MIG
                )
            }
        ):
            if not is_node_device_healthy(node):
                continue
            model, count, _ = _gfd(node)
            if not mig_model_known(model) or count < 1:
                continue
            per_gpu = _node_status_geometry(node, lambda n: MigProfile.parse(n))
            mps_claimed = _claimed_by_other_mode(node, MpsProfile.parse)
            try:
                gpus = [
                    MigGpu(
                        model,
                        idx,
                        per_gpu.get(idx, {}).get("geometry"),
                        per_gpu.get(idx, {}).get("used"),
                    )
                    for idx in range(count)
                    if idx not in mps_claimed
                ]
            except ValueError:
                # A node reporting a geometry the current menus consider
                # impossible (stale annotations, tables changed under it)
                # must not take down planning for the whole cluster.
                logger.exception(
                    "mig snapshot: node %s reports an infeasible geometry, "
                    "skipping it this cycle",
                    node.metadata.name,
                )
                continue
            name = node.metadata.name
            nodes[name] = GpuNode(
                name=name,
                gpus=gpus,
                profile_parser=MigProfile.from_resource,
                labels=node.metadata.labels,
                base_allocatable=node.status.allocatable,
                requested=cluster_state.node_requested(name),
                pods=cluster_state.node_pods(name),
            )
        return Snapshot(nodes, self.slice_spec)


class MpsSnapshotTaker:
    def __init__(self):
        self.slice_spec = MpsSliceSpec()

    def take_snapshot(self, cluster_state):
        from nos_tpu_torch.partitioning.core.snapshot import Snapshot

        from nos_tpu_torch.controllers.health import is_node_device_healthy

        nodes = {}
        for node in cluster_state.nodes(
            label_selector={
                constants.LABEL_PARTITIONING: constants.partitioning_label_values(
                    constants.KIND_MPS
                )
            }
        ):
            if not is_node_device_healthy(node):
                continue
            model, count, memory_gb = _gfd(node)
            if count < 1:
                continue
            memory_gb = memory_gb or constants.DEFAULT_GPU_MEMORY_GB
            per_gpu = _node_status_geometry(node, lambda n: MpsProfile.parse(n))
            mig_claimed = _claimed_by_other_mode(node, MigProfile.parse)
            gpus = [
                MpsGpu(
                    memory_gb,
                    idx,
                    per_gpu.get(idx, {}).get("geometry"),
                    per_gpu.get(idx, {}).get("used"),
                )
                for idx in range(count)
                if idx not in mig_claimed
            ]
            name = node.metadata.name
            nodes[name] = GpuNode(
                name=name,
                gpus=gpus,
                profile_parser=MpsProfile.from_resource,
                labels=node.metadata.labels,
                base_allocatable=node.status.allocatable,
                requested=cluster_state.node_requested(name),
                pods=cluster_state.node_pods(name),
            )
        return Snapshot(nodes, self.slice_spec)


# ---------------------------------------------------------------------------
# Partitioners (actuation channels)
# ---------------------------------------------------------------------------
def hybrid_contended_indexes(
    node: Node, accepts_own: Callable[[str], bool]
) -> set:
    """Device indexes on a hybrid node whose CURRENT spec annotations carry
    the other mode's profiles with nonzero quantity. Re-read at apply time
    (ADVICE r5, gpu_modes.py:245): when the MIG and MPS planners both claim
    the same uncarved GPU within one batch window, the snapshot-time
    `_claimed_by_other_mode` check sees neither spec yet — the tie-break is
    that the FIRST plan to land owns the GPU, and the second writer drops
    the contended index instead of publishing a merged geometry the agent's
    hybrid validator would reject (reject/replan churn until convergence)."""
    if node.metadata.labels.get(constants.LABEL_PARTITIONING) != constants.KIND_HYBRID:
        return set()
    return {
        s.device_index
        for s in ann.parse_spec(node.metadata.annotations)
        if s.quantity > 0 and not accepts_own(s.profile)
    }


class AnnotationPartitioner:
    """Spec-annotation writer shared by TPU and MIG modes. `profile_filter`
    scopes the rewrite to one mode's profiles so that on a hybrid node the
    MIG and MPS plans coexist instead of wiping each other."""

    def __init__(self, cluster: Cluster, profile_filter=None):
        self._cluster = cluster
        self._profile_filter = profile_filter

    def apply_partitioning(
        self, node_name: str, plan_id: str, partitioning: NodePartitioning
    ) -> None:
        def mutate(node: Node) -> None:
            # Scoped stripping ONLY on hybrid nodes: a non-hybrid node has a
            # single owner mode, so a full rewrite is the path that clears
            # stale other-mode specs left by a relabel (mps->mig) — left in
            # place they would poison the agent's reconcile forever.
            profile_filter = self._profile_filter
            node_kind = node.metadata.labels.get(constants.LABEL_PARTITIONING)
            if node_kind != constants.KIND_HYBRID:
                profile_filter = None
            desired = partitioning
            if profile_filter is not None:
                # Deterministic same-window contention tie-break: first
                # writer owns the GPU; we (the second) drop the contended
                # index — our own stale claim on it (if any) is stripped
                # below and never re-added, so a half-committed contention
                # actively converges instead of churning replans.
                contended = hybrid_contended_indexes(node, profile_filter)
                if contended:
                    desired = {
                        idx: profs
                        for idx, profs in partitioning.items()
                        if idx not in contended
                    }
                    dropped = sorted(set(partitioning) & contended)
                    logger.info(
                        "hybrid contention on %s: GPU index(es) %s already "
                        "claimed by the other mode's spec; dropping them "
                        "from plan %s",
                        node_name,
                        dropped,
                        plan_id,
                    )
            ann.strip_spec_annotations(node.metadata.annotations, profile_filter)
            specs = []
            for device_index, profiles in desired.items():
                specs.extend(
                    ann.SpecAnnotation(device_index, prof, qty)
                    for prof, qty in profiles.items()
                    if qty > 0
                )
            node.metadata.annotations.update(ann.format_spec(specs))
            node.metadata.annotations[constants.ANNOTATION_SPEC_PLAN] = plan_id

        self._cluster.patch("Node", "", node_name, mutate)


class MigPartitioner(AnnotationPartitioner):
    def __init__(self, cluster: Cluster):
        super().__init__(cluster, profile_filter=_parses_as(MigProfile.parse))


class MpsPartitioner:
    """MPS actuation: rewrite the device-plugin ConfigMap with the node's
    sharing config, then flip the node's device-plugin.config label to
    <node>-<plan> (mps/partitioner.go:61-157 ToPluginConfig analog). Spec
    annotations are still written for the plan handshake."""

    def __init__(
        self,
        cluster: Cluster,
        cm_name: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAME,
        cm_namespace: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE,
    ):
        self._cluster = cluster
        self._annotations = AnnotationPartitioner(
            cluster, profile_filter=_parses_as(MpsProfile.parse)
        )
        self.cm_name = cm_name
        self.cm_namespace = cm_namespace

    def plugin_config(self, partitioning: NodePartitioning) -> dict:
        """The nvidia device-plugin 'sharing' config for one node."""
        resources = []
        for gpu_index in sorted(partitioning):
            for prof, qty in sorted(partitioning[gpu_index].items()):
                if qty <= 0:
                    continue
                profile = MpsProfile.parse(prof)
                resources.append(
                    {
                        "name": profile.resource,
                        "rename": f"gpu-{profile.memory_gb}gb",
                        "memoryGB": profile.memory_gb,
                        "replicas": qty,
                        "devices": [gpu_index],
                    }
                )
        return {"version": "v1", "sharing": {"mps": {"resources": resources}}}

    def apply_partitioning(
        self, node_name: str, plan_id: str, partitioning: NodePartitioning
    ) -> None:
        # The device-plugin ConfigMap and the handshake annotations must
        # describe the SAME geometry: apply the hybrid contention tie-break
        # (first spec writer owns the GPU) before the payload is rendered,
        # not just inside the annotation mutate.
        try:
            node = self._cluster.get("Node", "", node_name)
        except NotFoundError:
            return
        contended = hybrid_contended_indexes(node, _parses_as(MpsProfile.parse))
        if contended:
            partitioning = {
                idx: profs
                for idx, profs in partitioning.items()
                if idx not in contended
            }
        config_key = f"{node_name}-{plan_id}"
        payload = json.dumps(self.plugin_config(partitioning), sort_keys=True)

        try:
            self._cluster.patch(
                "ConfigMap",
                self.cm_namespace,
                self.cm_name,
                lambda cm: cm.data.__setitem__(config_key, payload),
            )
        except NotFoundError:
            from nos_tpu_torch.api.objects import ObjectMeta

            self._cluster.create(
                ConfigMap(
                    metadata=ObjectMeta(name=self.cm_name, namespace=self.cm_namespace),
                    data={config_key: payload},
                )
            )
        # Write handshake annotations, then activate the config via the label.
        self._annotations.apply_partitioning(node_name, plan_id, partitioning)
        self._cluster.patch(
            "Node",
            "",
            node_name,
            lambda n: n.metadata.labels.__setitem__(
                constants.LABEL_DEVICE_PLUGIN_CONFIG, config_key
            ),
        )
