"""Port of `nos_tpu/cluster/serialize.py` (:1-488): `format_quantity` (:59),
`resources_to_wire` (:68), `resources_from_wire` (:74), `ts_to_wire` (:82),
`ts_from_wire` (:91), `meta_to_wire` (:99), `meta_from_wire` (:120),
`pod_to_wire` (:178), .... Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

Kubernetes wire-format codec for the typed object model.

The in-memory bus (cluster/client.py) stores typed Python objects; a real API
server speaks camelCase JSON. This module is the bijection between the two so
the same controllers can run over either backend. Wire shapes follow the
upstream kinds the reference consumes via client-go (core/v1 Pod, Node,
ConfigMap; policy/v1 PodDisruptionBudget) and the CRDs in deploy/crds.yaml
(tpu.nos/v1alpha1 ElasticQuota / CompositeElasticQuota — reference
pkg/api/nos.nebuly.com/v1alpha1/{elasticquota_types.go:30-71,
compositeelasticquota_types.go:29-66}).

Quantities: cpu is cores, memory is bytes, extended resources are counts
(api/resources.py). Formatting picks the shortest k8s-legal spelling that
round-trips through parse_quantity.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from nos_tpu_torch.api.objects import (
    ConfigMap,
    Container,
    Lease,
    LeaseSpec,
    Node,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodDisruptionBudgetSpec,
    PodDisruptionBudgetStatus,
    PodSpec,
    PodStatus,
)
from nos_tpu_torch.api.quota_types import (
    CompositeElasticQuota,
    CompositeElasticQuotaSpec,
    ElasticQuota,
    ElasticQuotaSpec,
    ElasticQuotaStatus,
)
from nos_tpu_torch.api.resources import ResourceList, parse_quantity
from nos_tpu_torch.constants import DOMAIN

# The CRD API group IS the protocol domain (deploy/crds.yaml): a drifted
# apiVersion here desynchronizes every EQ/CEQ round-trip with the emulator
# and the chart, so both derive from the one constant.
QUOTA_API_GROUP = DOMAIN
QUOTA_API_VERSION = "v1alpha1"
QUOTA_APIVERSION = f"{QUOTA_API_GROUP}/{QUOTA_API_VERSION}"


# -- quantities --------------------------------------------------------------
def format_quantity(value: float) -> str:
    if float(value).is_integer():
        return str(int(value))
    milli = value * 1000.0
    if abs(milli - round(milli)) < 1e-9:
        return f"{int(round(milli))}m"
    return repr(float(value))


def resources_to_wire(rl: Optional[ResourceList]) -> Optional[Dict[str, str]]:
    if rl is None:
        return None
    return {name: format_quantity(q) for name, q in sorted(rl.items())}


def resources_from_wire(data: Optional[Dict[str, Any]]) -> ResourceList:
    out = ResourceList()
    for name, q in (data or {}).items():
        out[name] = parse_quantity(q)
    return out


# -- timestamps --------------------------------------------------------------
def ts_to_wire(ts: Optional[float]) -> Optional[str]:
    if ts is None or ts == 0.0:
        return None
    dt = _dt.datetime.fromtimestamp(ts, tz=_dt.timezone.utc)
    # Microseconds preserved so creation-order sorts survive a round trip
    # (the API server proper truncates to seconds; it accepts fractions).
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def ts_from_wire(s: Optional[str]) -> float:
    if not s:
        return 0.0
    s = s.replace("Z", "+00:00")
    return _dt.datetime.fromisoformat(s).timestamp()


# -- metadata ----------------------------------------------------------------
def meta_to_wire(meta: ObjectMeta) -> Dict[str, Any]:
    out: Dict[str, Any] = {"name": meta.name}
    if meta.namespace:
        out["namespace"] = meta.namespace
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    if meta.uid:
        out["uid"] = meta.uid
    if meta.resource_version:
        out["resourceVersion"] = str(meta.resource_version)
    ct = ts_to_wire(meta.creation_timestamp)
    if ct:
        out["creationTimestamp"] = ct
    dt = ts_to_wire(meta.deletion_timestamp)
    if dt:
        out["deletionTimestamp"] = dt
    return out


def meta_from_wire(data: Dict[str, Any]) -> ObjectMeta:
    rv_raw = data.get("resourceVersion", 0)
    try:
        rv = int(rv_raw)
    except (TypeError, ValueError):
        # Real API servers hand out opaque strings; preserve them verbatim so
        # the optimistic-concurrency echo-back still matches server state
        # (the field is typed int for the in-memory bus, but only equality
        # ever matters).
        rv = str(rv_raw)
    deletion = data.get("deletionTimestamp")
    return ObjectMeta(
        name=data.get("name") or "",
        namespace=data.get("namespace") or "",
        labels=dict(data.get("labels") or {}),
        annotations=dict(data.get("annotations") or {}),
        uid=data.get("uid", ""),
        resource_version=rv,
        creation_timestamp=ts_from_wire(data.get("creationTimestamp")),
        deletion_timestamp=ts_from_wire(deletion) if deletion else None,
    )


# -- per-kind codecs ---------------------------------------------------------
def _container_to_wire(c: Container) -> Dict[str, Any]:
    return {
        "name": c.name,
        "resources": {"requests": resources_to_wire(c.resources) or {}},
    }


def _container_from_wire(d: Dict[str, Any]) -> Container:
    res = (d.get("resources") or {})
    requests = res.get("requests") or res.get("limits")
    return Container(name=d.get("name", "main"), resources=resources_from_wire(requests))


_OWNER_API_VERSIONS = {
    "DaemonSet": "apps/v1",
    "Deployment": "apps/v1",
    "ReplicaSet": "apps/v1",
    "StatefulSet": "apps/v1",
    "Job": "batch/v1",
    "CronJob": "batch/v1",
}


def _owner_ref_to_wire(o: OwnerReference) -> Dict[str, Any]:
    # apiVersion and uid are required by a real API server's owner-reference
    # validation; default them when the in-process caller didn't care.
    return {
        "apiVersion": o.api_version or _OWNER_API_VERSIONS.get(o.kind, "v1"),
        "kind": o.kind,
        "name": o.name,
        "uid": o.uid or f"uid-{o.kind.lower()}-{o.name}",
    }


def pod_to_wire(pod: Pod) -> Dict[str, Any]:
    meta = meta_to_wire(pod.metadata)
    if pod.owner_references:
        meta["ownerReferences"] = [_owner_ref_to_wire(o) for o in pod.owner_references]
    spec: Dict[str, Any] = {
        "containers": [_container_to_wire(c) for c in pod.spec.containers],
        "schedulerName": pod.spec.scheduler_name,
    }
    if pod.spec.init_containers:
        spec["initContainers"] = [_container_to_wire(c) for c in pod.spec.init_containers]
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    if pod.spec.priority:
        spec["priority"] = pod.spec.priority
    if pod.spec.overhead:
        spec["overhead"] = resources_to_wire(pod.spec.overhead)
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    status: Dict[str, Any] = {"phase": pod.status.phase}
    if pod.status.conditions:
        status["conditions"] = [
            {"type": c.type, "status": c.status, "reason": c.reason}
            for c in pod.status.conditions
        ]
    if pod.status.nominated_node_name:
        status["nominatedNodeName"] = pod.status.nominated_node_name
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": spec,
        "status": status,
    }


def pod_from_wire(data: Dict[str, Any]) -> Pod:
    meta_raw = data.get("metadata") or {}
    spec_raw = data.get("spec") or {}
    status_raw = data.get("status") or {}
    return Pod(
        metadata=meta_from_wire(meta_raw),
        spec=PodSpec(
            containers=[_container_from_wire(c) for c in spec_raw.get("containers") or []],
            init_containers=[
                _container_from_wire(c) for c in spec_raw.get("initContainers") or []
            ],
            node_name=spec_raw.get("nodeName", ""),
            scheduler_name=spec_raw.get("schedulerName", "default-scheduler"),
            priority=spec_raw.get("priority") or 0,
            overhead=resources_from_wire(spec_raw.get("overhead")),
            node_selector=dict(spec_raw.get("nodeSelector") or {}),
        ),
        status=PodStatus(
            phase=status_raw.get("phase", "Pending"),
            conditions=[
                PodCondition(
                    type=c.get("type", ""),
                    status=c.get("status", ""),
                    reason=c.get("reason", ""),
                )
                for c in status_raw.get("conditions") or []
            ],
            nominated_node_name=status_raw.get("nominatedNodeName", ""),
        ),
        owner_references=[
            OwnerReference(
                kind=o.get("kind", ""),
                name=o.get("name", ""),
                api_version=o.get("apiVersion", ""),
                uid=o.get("uid", ""),
            )
            for o in meta_raw.get("ownerReferences") or []
        ],
    )


def node_to_wire(node: Node) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": meta_to_wire(node.metadata),
        "status": {
            "capacity": resources_to_wire(node.status.capacity) or {},
            "allocatable": resources_to_wire(node.status.allocatable) or {},
        },
    }


def node_from_wire(data: Dict[str, Any]) -> Node:
    status_raw = data.get("status") or {}
    return Node(
        metadata=meta_from_wire(data.get("metadata") or {}),
        status=NodeStatus(
            capacity=resources_from_wire(status_raw.get("capacity")),
            allocatable=resources_from_wire(status_raw.get("allocatable")),
        ),
    )


def configmap_to_wire(cm: ConfigMap) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": meta_to_wire(cm.metadata),
        "data": dict(cm.data),
    }


def configmap_from_wire(data: Dict[str, Any]) -> ConfigMap:
    return ConfigMap(
        metadata=meta_from_wire(data.get("metadata") or {}),
        data=dict(data.get("data") or {}),
    )


def pdb_to_wire(pdb: PodDisruptionBudget) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"selector": {"matchLabels": dict(pdb.spec.selector)}}
    if pdb.spec.min_available is not None:
        spec["minAvailable"] = pdb.spec.min_available
    if pdb.spec.max_unavailable is not None:
        spec["maxUnavailable"] = pdb.spec.max_unavailable
    return {
        "apiVersion": "policy/v1",
        "kind": "PodDisruptionBudget",
        "metadata": meta_to_wire(pdb.metadata),
        "spec": spec,
        "status": {
            "disruptionsAllowed": pdb.status.disruptions_allowed,
            "currentHealthy": pdb.status.current_healthy,
            "desiredHealthy": pdb.status.desired_healthy,
            "expectedPods": pdb.status.expected_pods,
        },
    }


def pdb_from_wire(data: Dict[str, Any]) -> PodDisruptionBudget:
    spec_raw = data.get("spec") or {}
    status_raw = data.get("status") or {}
    selector = (spec_raw.get("selector") or {}).get("matchLabels") or {}
    return PodDisruptionBudget(
        metadata=meta_from_wire(data.get("metadata") or {}),
        spec=PodDisruptionBudgetSpec(
            selector=dict(selector),
            min_available=spec_raw.get("minAvailable"),
            max_unavailable=spec_raw.get("maxUnavailable"),
        ),
        status=PodDisruptionBudgetStatus(
            disruptions_allowed=status_raw.get("disruptionsAllowed") or 0,
            current_healthy=status_raw.get("currentHealthy") or 0,
            desired_healthy=status_raw.get("desiredHealthy") or 0,
            expected_pods=status_raw.get("expectedPods") or 0,
        ),
    )


def lease_to_wire(lease: Lease) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if lease.spec.holder_identity:
        spec["holderIdentity"] = lease.spec.holder_identity
    spec["leaseDurationSeconds"] = lease.spec.lease_duration_seconds
    at = ts_to_wire(lease.spec.acquire_time)
    if at:
        spec["acquireTime"] = at
    rt = ts_to_wire(lease.spec.renew_time)
    if rt:
        spec["renewTime"] = rt
    if lease.spec.lease_transitions:
        spec["leaseTransitions"] = lease.spec.lease_transitions
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": meta_to_wire(lease.metadata),
        "spec": spec,
    }


def lease_from_wire(data: Dict[str, Any]) -> Lease:
    spec_raw = data.get("spec") or {}
    return Lease(
        metadata=meta_from_wire(data.get("metadata") or {}),
        spec=LeaseSpec(
            holder_identity=spec_raw.get("holderIdentity") or "",
            lease_duration_seconds=spec_raw.get("leaseDurationSeconds") or 15,
            acquire_time=ts_from_wire(spec_raw.get("acquireTime")),
            renew_time=ts_from_wire(spec_raw.get("renewTime")),
            lease_transitions=spec_raw.get("leaseTransitions") or 0,
        ),
    )


def eq_to_wire(eq: ElasticQuota) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"min": resources_to_wire(eq.spec.min) or {}}
    if eq.spec.max is not None:
        spec["max"] = resources_to_wire(eq.spec.max)
    return {
        "apiVersion": QUOTA_APIVERSION,
        "kind": "ElasticQuota",
        "metadata": meta_to_wire(eq.metadata),
        "spec": spec,
        "status": {"used": resources_to_wire(eq.status.used) or {}},
    }


def eq_from_wire(data: Dict[str, Any]) -> ElasticQuota:
    spec_raw = data.get("spec") or {}
    status_raw = data.get("status") or {}
    return ElasticQuota(
        metadata=meta_from_wire(data.get("metadata") or {}),
        spec=ElasticQuotaSpec(
            min=resources_from_wire(spec_raw.get("min")),
            max=resources_from_wire(spec_raw["max"]) if spec_raw.get("max") is not None else None,
        ),
        status=ElasticQuotaStatus(used=resources_from_wire(status_raw.get("used"))),
    )


def ceq_to_wire(ceq: CompositeElasticQuota) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "namespaces": list(ceq.spec.namespaces),
        "min": resources_to_wire(ceq.spec.min) or {},
    }
    if ceq.spec.max is not None:
        spec["max"] = resources_to_wire(ceq.spec.max)
    return {
        "apiVersion": QUOTA_APIVERSION,
        "kind": "CompositeElasticQuota",
        "metadata": meta_to_wire(ceq.metadata),
        "spec": spec,
        "status": {"used": resources_to_wire(ceq.status.used) or {}},
    }


def ceq_from_wire(data: Dict[str, Any]) -> CompositeElasticQuota:
    spec_raw = data.get("spec") or {}
    status_raw = data.get("status") or {}
    return CompositeElasticQuota(
        metadata=meta_from_wire(data.get("metadata") or {}),
        spec=CompositeElasticQuotaSpec(
            namespaces=list(spec_raw.get("namespaces") or []),
            min=resources_from_wire(spec_raw.get("min")),
            max=resources_from_wire(spec_raw["max"]) if spec_raw.get("max") is not None else None,
        ),
        status=ElasticQuotaStatus(used=resources_from_wire(status_raw.get("used"))),
    )


# -- registry ----------------------------------------------------------------
@dataclass(frozen=True)
class KindInfo:
    kind: str
    group: str  # "" = core
    version: str
    plural: str
    namespaced: bool
    to_wire: Callable[[Any], Dict[str, Any]]
    from_wire: Callable[[Dict[str, Any]], Any]
    has_status_subresource: bool = False

    @property
    def api_prefix(self) -> str:
        if self.group == "":
            return f"/api/{self.version}"
        return f"/apis/{self.group}/{self.version}"

    def path_for(self, namespace: str = "", name: str = "") -> str:
        p = self.api_prefix
        if self.namespaced and namespace:
            p += f"/namespaces/{namespace}"
        p += f"/{self.plural}"
        if name:
            p += f"/{name}"
        return p


KINDS: Dict[str, KindInfo] = {
    "Pod": KindInfo("Pod", "", "v1", "pods", True, pod_to_wire, pod_from_wire, True),
    "Node": KindInfo("Node", "", "v1", "nodes", False, node_to_wire, node_from_wire, True),
    "ConfigMap": KindInfo(
        "ConfigMap", "", "v1", "configmaps", True, configmap_to_wire, configmap_from_wire
    ),
    "PodDisruptionBudget": KindInfo(
        "PodDisruptionBudget", "policy", "v1", "poddisruptionbudgets", True,
        pdb_to_wire, pdb_from_wire, True,
    ),
    "Lease": KindInfo(
        "Lease", "coordination.k8s.io", "v1", "leases", True,
        lease_to_wire, lease_from_wire,
    ),
    "ElasticQuota": KindInfo(
        "ElasticQuota", QUOTA_API_GROUP, QUOTA_API_VERSION, "elasticquotas", True,
        eq_to_wire, eq_from_wire, True,
    ),
    "CompositeElasticQuota": KindInfo(
        "CompositeElasticQuota", QUOTA_API_GROUP, QUOTA_API_VERSION,
        "compositeelasticquotas", True, ceq_to_wire, ceq_from_wire, True,
    ),
}

KINDS_BY_PLURAL: Dict[str, KindInfo] = {info.plural: info for info in KINDS.values()}


def to_wire(obj: Any) -> Dict[str, Any]:
    kind = getattr(obj, "KIND", type(obj).__name__)
    return KINDS[kind].to_wire(obj)


def from_wire(data: Dict[str, Any]) -> Any:
    kind = data.get("kind", "")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    return KINDS[kind].from_wire(data)
