"""Port of `nos_tpu/controllers/tpu_agent.py:1` (:1-385): `SharedState` (:42),
`TpuAgent` (:65). Copied verbatim; only the imports point at the port, which
imports nothing of the JAX package.

tpuagent: the node-local daemon applying and reporting sub-slice geometry.

The TPU analog of the migagent reporter/actuator pair
(internal/controllers/migagent/{actuator.go, reporter.go, shared.go} and the
plan diff engine in migagent/plan/plan.go:31-134):

  - the *actuator* reacts to spec-annotation changes: parses desired geometry,
    diffs it against actual device state (via TpuClient), deletes surplus free
    slices, creates missing ones around the kept ones — never touching a slice
    in use — and tolerates partial application when fragmentation blocks the
    full plan;
  - the *reporter* writes status annotations + the plan-id handshake and
    refreshes node.status.allocatable (standing in for device-plugin
    re-registration after MIG changes, gpu/client.go:51-132).

Crash safety mirrors the reference: on startup, delete every slice not in use
(cmd/migagent/migagent.go:190-199); status is always recomputed from the device
layer, never trusted from annotations.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api import annotations as ann
from nos_tpu_torch.api.objects import Node
from nos_tpu_torch.api.resources import compute_pod_request
from nos_tpu_torch.cluster.client import Cluster, Event, EventType, NotFoundError
from nos_tpu_torch.tpu import Profile
from nos_tpu_torch.tpu.packing import pack_into
from nos_tpu_torch.tpulib.interface import SliceHandle, TpuClient, TpuLibError
from nos_tpu_torch.util import pod as podutil

logger = logging.getLogger(__name__)

DEVICE_INDEX = 0


class SharedState:
    """Reporter/actuator coordination (migagent/shared.go:24-57): the actuator
    refuses to apply a new plan until at least one report has happened since
    the previous apply (so it diffs against fresh status)."""

    def __init__(self):
        self.lock = threading.RLock()
        self._reported_since_apply = True
        self.last_parsed_plan_id: Optional[str] = None

    def on_report(self) -> None:
        with self.lock:
            self._reported_since_apply = True

    def on_apply(self) -> None:
        with self.lock:
            self._reported_since_apply = False

    def at_least_one_report_since_last_apply(self) -> bool:
        with self.lock:
            return self._reported_since_apply


class TpuAgent:
    def __init__(
        self,
        cluster: Cluster,
        node_name: str,
        client: TpuClient,
        pod_resources_lister=None,
    ):
        self.cluster = cluster
        self.node_name = node_name
        self.client = client
        self.shared = SharedState()
        self.pod_resources_lister = pod_resources_lister
        self._unsub = None
        # (key, chip) gauge series exported last report — cleared when a
        # chip stops reporting so /metrics never serves frozen values.
        self._chip_gauges: set = set()

    # -- lifecycle ----------------------------------------------------------
    def startup(self) -> None:
        """Crash recovery: re-sync usage, drop every slice not in use, then
        run one reconcile (controller-runtime delivers an initial event on
        start): it re-parses any standing spec so the plan-id handshake
        resumes after a restart, re-applies it, and reports actual state."""
        self.sync_usage_from_pods()
        used_ids = [s.slice_id for s in self.client.list_slices() if s.in_use]
        deleted = self.client.delete_all_except(used_ids)
        if deleted:
            logger.info("tpuagent %s: startup cleanup removed %s", self.node_name, deleted)
        self.reconcile()

    def start_watching(self) -> None:
        from nos_tpu_torch.util import predicates as pred

        trigger = pred.all_of(
            pred.exclude_delete,
            pred.matching_name(self.node_name),
            pred.spec_annotations_changed,
        )
        self._unsub = self.cluster.watch(
            "Node", pred.filtered(trigger, lambda ev: self.reconcile()), replay=False
        )

    def stop(self) -> None:
        if self._unsub:
            self._unsub()

    def pod_resources(self):
        """Device accounting view (kubelet pod-resources API seam,
        resource/client.go:26-87). On a real node this is the kubelet gRPC
        socket client (cluster/pod_resources_grpc.py); in-process it derives
        from the TpuClient's carved slices."""
        if self.pod_resources_lister is not None:
            return self.pod_resources_lister
        from nos_tpu_torch.cluster.pod_resources import TpuPodResources

        return TpuPodResources(self.client)

    # -- usage sync (pod-resources gRPC analog) ------------------------------
    def sync_usage_from_pods(self) -> None:
        """Mark slices in-use according to pods bound to this node — the
        stand-in for the kubelet pod-resources socket (resource/client.go:26-87).
        Deterministic assignment: slices sorted by id, pods by name."""
        demand: Dict[Profile, int] = {}
        for pod in self.cluster.list("Pod", predicate=lambda p: p.spec.node_name == self.node_name):
            if not podutil.is_active(pod):
                continue
            for res, qty in compute_pod_request(pod).items():
                profile = Profile.from_resource(res)
                if profile is not None and qty > 0:
                    demand[profile] = demand.get(profile, 0) + int(round(qty))
        for handle in sorted(self.client.list_slices(), key=lambda s: s.slice_id):
            want_used = demand.get(handle.profile, 0) > 0
            if want_used:
                demand[handle.profile] -= 1
            if handle.in_use != want_used:
                self.client.set_slice_in_use(handle.slice_id, want_used)

    # -- actuator -----------------------------------------------------------
    def reconcile(self) -> None:
        """Apply spec -> device state, then report (actuator.go:71-201)."""
        node = self.cluster.try_get("Node", "", self.node_name)
        if node is None:
            return
        if not self.shared.at_least_one_report_since_last_apply():
            self.report()
        specs = ann.parse_spec(node.metadata.annotations)
        plan_id = ann.get_spec_plan(node.metadata.annotations)
        self.shared.last_parsed_plan_id = plan_id
        desired: Dict[Profile, int] = {}
        for s in specs:
            if s.device_index == DEVICE_INDEX and s.quantity > 0:
                desired[Profile.parse(s.profile)] = (
                    desired.get(Profile.parse(s.profile), 0) + s.quantity
                )
        status = ann.parse_status(node.metadata.annotations)
        if ann.spec_matches_status(specs, status) and self.shared.at_least_one_report_since_last_apply():
            # Still refresh the handshake so the planner unblocks.
            self.report()
            return
        self.sync_usage_from_pods()
        holds = ann.get_migration_hold(node.metadata.annotations)
        try:
            self._apply(desired, holds)
        except TpuLibError:
            logger.exception("tpuagent %s: apply failed; reporting actual state", self.node_name)
        self.shared.on_apply()
        self.report()

    def _apply(
        self, desired: Dict[Profile, int], holds: Optional[Dict[str, int]] = None
    ) -> None:
        # `holds` (profile name -> count) marks free slices that are
        # in-flight migration DESTINATIONS: the delete-free-first ladder is
        # extended to moves by treating up to <count> free slices of each
        # held profile exactly like used ones — undeletable — until the
        # mover rebinds (or the controller's reservation expires and clears
        # the annotation). Without this, the fragmentation fallback below
        # could tear down the very slice a drain already depends on.
        holds = dict(holds or {})
        slices = self.client.list_slices()
        current: Dict[Profile, List[SliceHandle]] = {}
        for s in slices:
            current.setdefault(s.profile, []).append(s)

        # 1. Delete surplus free slices per profile (free first, never used —
        #    plan/plan.go extractCandidatesForDeletion:111-134).
        for profile, handles in current.items():
            surplus = len(handles) - desired.get(profile, 0)
            if surplus <= 0:
                continue
            free = [h for h in handles if not h.in_use]
            held = holds.get(profile.name, 0)
            for h in free[held:held + surplus]:
                self.client.delete_slice(h.slice_id)

        # 2. Create missing slices around the kept ones.
        kept = self.client.list_slices()
        missing: Dict[Profile, int] = {}
        kept_counts: Dict[Profile, int] = {}
        for s in kept:
            kept_counts[s.profile] = kept_counts.get(s.profile, 0) + 1
        for profile, want in desired.items():
            extra = want - kept_counts.get(profile, 0)
            if extra > 0:
                missing[profile] = extra
        if not missing:
            return
        topology = self.client.get_topology()
        occupied = [(s.origin, s.dims) for s in kept]
        placements = pack_into(topology.shape, occupied, missing)
        if placements is None:
            # Fragmentation: drop remaining free slices and retry
            # (the widened-permutation-space analog of plan/plan.go:94-109).
            # Held (migration-destination) free slices survive the drop,
            # first-listed per profile for determinism.
            spare = dict(holds)
            for s in sorted(kept, key=lambda s: s.slice_id):
                if s.in_use:
                    continue
                if spare.get(s.profile.name, 0) > 0:
                    spare[s.profile.name] -= 1
                    continue
                self.client.delete_slice(s.slice_id)
            kept = self.client.list_slices()
            kept_counts = {}
            for s in kept:
                kept_counts[s.profile] = kept_counts.get(s.profile, 0) + 1
            missing = {
                p: want - kept_counts.get(p, 0)
                for p, want in desired.items()
                if want - kept_counts.get(p, 0) > 0
            }
            occupied = [(s.origin, s.dims) for s in kept]
            placements = pack_into(topology.shape, occupied, missing)
        if placements is None:
            # Partial application: place as many as fit, largest first
            # (the reference applies plans partially too, SURVEY §5).
            placements = []
            occupied = [(s.origin, s.dims) for s in self.client.list_slices()]
            for profile in sorted(missing, key=lambda p: (-p.chips, p.name)):
                for _ in range(missing[profile]):
                    got = pack_into(topology.shape, occupied, {profile: 1})
                    if got:
                        placements.extend(got)
                        occupied.extend((pl.origin, pl.dims) for pl in got)
        for pl in placements:
            self.client.create_slice(pl.profile, pl.origin, pl.dims)

    # -- reporter -----------------------------------------------------------
    def report(self) -> None:
        """Write status annotations + allocatable from actual device state
        (reporter.go:54-109). Runs on reconcile AND periodically (the
        reference's reportConfigIntervalSeconds): without the periodic pass,
        slices freed by completed pods would stay marked used in the status
        annotations and the planner's never-delete-used invariant would block
        reshaping them. The patch is skipped when nothing changed, so the
        periodic pass does not churn the watch bus."""
        self.sync_usage_from_pods()
        slices = self.client.list_slices()
        geometry: Dict[Profile, int] = {}
        used: Dict[Profile, int] = {}
        for s in slices:
            geometry[s.profile] = geometry.get(s.profile, 0) + 1
            if s.in_use:
                used[s.profile] = used.get(s.profile, 0) + 1
        topology = self.client.get_topology()
        carved = sum(p.chips * n for p, n in geometry.items())
        from nos_tpu_torch.observability import metrics

        metrics.set_gauge("nos_tpu_chips_total", topology.chips, node=self.node_name)
        metrics.set_gauge("nos_tpu_chips_carved", carved, node=self.node_name)
        metrics.set_gauge(
            "nos_tpu_chips_used",
            sum(p.chips * n for p, n in used.items()),
            node=self.node_name,
        )
        # Real-silicon backends (tpulib/local.py) expose per-chip runtime
        # stats; export whatever the runtime reports (HBM gauges are the
        # DCGM-exporter-style per-device telemetry of the reference's GPU
        # world). Modeled backends have no device_stats — nothing exported.
        device_stats = getattr(self.client, "device_stats", None)
        if device_stats is not None:
            live = set()
            for i, entry in enumerate(device_stats()):
                # Index fallback keeps coord-less chips' series DISTINCT —
                # collapsing them onto one label would silently overwrite
                # every chip's gauges with the last one's.
                chip = "x".join(str(c) for c in entry.get("coords", ())) or str(i)
                for key in (
                    "hbm_bytes_in_use",
                    "hbm_bytes_limit",
                    "hbm_peak_bytes_in_use",
                ):
                    if key in entry:
                        metrics.set_gauge(
                            f"nos_tpu_chip_{key}",
                            entry[key],
                            node=self.node_name,
                            chip=chip,
                        )
                        live.add((key, chip))
            # A chip that stopped reporting must DROP its series: a frozen
            # last value on /metrics reads as a live measurement.
            for key, chip in self._chip_gauges - live:
                metrics.remove_gauge(
                    f"nos_tpu_chip_{key}", node=self.node_name, chip=chip
                )
            self._chip_gauges = live
        desired_status = dict(
            ann.format_status(ann.status_from_geometry(DEVICE_INDEX, geometry, used))
        )
        layout = ann.format_layout(
            ann.SliceLayoutEntry(
                profile=s.profile.name,
                origin=tuple(s.origin),
                dims=tuple(s.dims),
                used=s.in_use,
            )
            for s in slices
        )
        if layout:
            desired_status[constants.ANNOTATION_STATUS_LAYOUT] = layout
        if self.shared.last_parsed_plan_id is not None:
            desired_status[constants.ANNOTATION_STATUS_PLAN] = (
                self.shared.last_parsed_plan_id
            )
        desired_alloc = {constants.RESOURCE_TPU: float(topology.chips - carved)}
        for p, n in geometry.items():
            desired_alloc[p.resource] = float(n)

        def unchanged(node: Node) -> bool:
            current_status = {
                k: v
                for k, v in node.metadata.annotations.items()
                if constants.ANNOTATION_STATUS_REGEX.match(k)
                or k == constants.ANNOTATION_STATUS_PLAN
                or k == constants.ANNOTATION_STATUS_LAYOUT
            }
            if current_status != desired_status:
                return False
            current_alloc = {
                r: node.status.allocatable[r]
                for r in node.status.allocatable
                if constants.RESOURCE_TPU_SLICE_REGEX.match(r)
                or r == constants.RESOURCE_TPU
            }
            return current_alloc == desired_alloc

        def mutate(node: Node) -> None:
            ann.strip_status_annotations(node.metadata.annotations)
            if self.shared.last_parsed_plan_id is None:
                # A stale plan id from a previous agent run would otherwise
                # survive every rewrite and keep unchanged() false forever.
                node.metadata.annotations.pop(constants.ANNOTATION_STATUS_PLAN, None)
            node.metadata.annotations.update(desired_status)
            # Device-plugin re-registration analog: refresh extended resources.
            for res in [
                r
                for r in node.status.allocatable
                if constants.RESOURCE_TPU_SLICE_REGEX.match(r)
            ]:
                del node.status.allocatable[res]
            for res, qty in desired_alloc.items():
                node.status.allocatable[res] = qty
            node.status.capacity = type(node.status.allocatable)(node.status.allocatable)

        try:
            node = self.cluster.try_get("Node", "", self.node_name)
            if node is None:
                return
            if not unchanged(node):
                self.cluster.patch("Node", "", self.node_name, mutate)
        except NotFoundError:
            return
        self.shared.on_report()


# The spec-annotation view used by the reconcile trigger lives in
# nos_tpu_torch.util.predicates (spec_annotations_changed) so every agent shares
# one definition.
