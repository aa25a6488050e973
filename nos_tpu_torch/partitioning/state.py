"""Port of `nos_tpu/partitioning/state.py:1` (:1-167): `MigrationNote` (:23),
`ClusterState` (:40). Copied verbatim; only the imports point at the port,
which imports nothing of the JAX package.

ClusterState: a watch-fed, mutex-guarded mirror of nodes and pods.

Analog of internal/partitioning/state/state.go:49-222. Controllers feed it
from cluster watch events; the snapshot takers read it. Pure cache — it can
always be rebuilt by re-listing (the "annotations are the database" design,
SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Node, Pod
from nos_tpu_torch.api.resources import ResourceList, compute_pod_request
from nos_tpu_torch.cluster.client import Cluster, Event, EventType
from nos_tpu_torch.util import pod as podutil


@dataclass
class MigrationNote:
    """One in-flight slice migration: `pod_key`'s slice was drained from
    `source_node` after an equivalent slice was created on `dest_node`, and
    the mover has not yet rebound. While a note is active, the snapshot
    takers mark `request` used on the destination so a CONCURRENT replan
    cannot double-claim the reserved slice, and the tracker skips the
    mover's resubmitted pod (its capacity already exists). `expires_at`
    bounds a lost mover (deleted instead of resubmitted): after it, the
    reservation lapses and the slice returns to the free pool."""

    pod_key: str
    source_node: str
    dest_node: str
    request: ResourceList
    expires_at: float


class ClusterState:
    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[str, Node] = {}
        self._pods: Dict[str, Pod] = {}  # key: ns/name, only scheduled+active pods
        self._migrations: Dict[str, MigrationNote] = {}  # key: mover pod key

    # -- feeding -----------------------------------------------------------
    def update_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.metadata.name] = node

    def delete_node(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)
            for key in [k for k, p in self._pods.items() if p.spec.node_name == name]:
                del self._pods[key]

    def update_pod(self, pod: Pod) -> None:
        """Track pods that consume node resources (state.go UpdateUsage:153-180)."""
        with self._lock:
            key = pod.metadata.namespaced_name
            if podutil.is_active(pod):
                self._pods[key] = pod
                if pod.spec.node_name:
                    # The mover rebound: its migration completed, the
                    # reservation's job is done (the pod itself now holds
                    # the destination slice in the usage accounting).
                    self._migrations.pop(key, None)
            else:
                self._pods.pop(key, None)

    def delete_pod(self, namespaced_name: str) -> None:
        with self._lock:
            self._pods.pop(namespaced_name, None)

    def start_watching(self, cluster: Cluster) -> None:
        """Wire watch streams (NodeController/PodController analog,
        node_controller.go:50-95, pod_controller.go:47-104)."""

        def on_node(ev: Event) -> None:
            if ev.type == EventType.DELETED:
                self.delete_node(ev.obj.metadata.name)
            else:
                self.update_node(ev.obj)

        def on_pod(ev: Event) -> None:
            if ev.type == EventType.DELETED:
                self.delete_pod(ev.obj.metadata.namespaced_name)
            else:
                self.update_pod(ev.obj)

        cluster.watch("Node", on_node)
        cluster.watch("Pod", on_pod)

    # -- reading -----------------------------------------------------------
    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            n = self._nodes.get(name)
            return n.deepcopy() if n is not None else None

    def nodes(self, label_selector: Optional[Dict[str, str]] = None) -> List[Node]:
        """Nodes, optionally filtered. A selector value may be a str (exact
        match) or a tuple/set/list of accepted values (the k8s set-based
        `key in (a, b)` selector form — used by the GPU modes, whose nodes
        may be labeled with their own kind OR `hybrid`)."""
        with self._lock:
            out = []
            for n in self._nodes.values():
                if label_selector and any(
                    n.metadata.labels.get(k) not in v
                    if isinstance(v, (tuple, set, frozenset, list))
                    else n.metadata.labels.get(k) != v
                    for k, v in label_selector.items()
                ):
                    continue
                out.append(n.deepcopy())
            out.sort(key=lambda n: n.metadata.name)
            return out

    def node_pods(self, node_name: str) -> List[Pod]:
        with self._lock:
            return sorted(
                (p.deepcopy() for p in self._pods.values() if p.spec.node_name == node_name),
                key=lambda p: p.metadata.namespaced_name,
            )

    def node_requested(self, node_name: str) -> ResourceList:
        with self._lock:
            out = ResourceList()
            for p in self._pods.values():
                if p.spec.node_name == node_name:
                    out = out.add(compute_pod_request(p))
            return out

    # -- in-flight migration accounting -------------------------------------
    def note_migration(self, note: MigrationNote) -> None:
        with self._lock:
            self._migrations[note.pod_key] = note

    def clear_migration(self, pod_key: str) -> None:
        with self._lock:
            self._migrations.pop(pod_key, None)

    def prune_migrations(self, now: float) -> None:
        """Expire reservations whose mover never came back (clock injected:
        the caller's controller clock drives expiry, never wall time — the
        simulations run on a virtual timeline)."""
        with self._lock:
            for key in [
                k for k, n in self._migrations.items() if now >= n.expires_at
            ]:
                del self._migrations[key]

    def active_migrations(self) -> List[MigrationNote]:
        with self._lock:
            return sorted(self._migrations.values(), key=lambda n: n.pod_key)

    def partitioning_enabled(self, kind: str) -> bool:
        """Any node labeled for this partitioning mode — a hybrid-labeled
        node enables both GPU modes (state.go IsPartitioningEnabled:216-222;
        hybrid completion per constants.KIND_HYBRID)."""
        values = constants.partitioning_label_values(kind)
        with self._lock:
            return any(
                n.metadata.labels.get(constants.LABEL_PARTITIONING) in values
                for n in self._nodes.values()
            )
