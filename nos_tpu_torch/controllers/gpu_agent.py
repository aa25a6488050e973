"""Port of `nos_tpu/controllers/gpu_agent.py:1` (:1-464): `GpuDevice` (:32),
`FakeGpuDeviceClient` (:39), `mig_validator` (:108), `mps_validator` (:120),
`hybrid_validator` (:141), `hybrid_parse_profile` (:165),
`hybrid_resource_of` (:172), `GpuAgent` (:180). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

GPU node agents: MIG and MPS (migagent / gpuagent analog).

One generic agent covers both modes — the diff engine is count-based per
(GPU index, profile) with the never-delete-used invariant and free-first
deletion ordering of migagent/plan/plan.go:31-134; MIG validity (geometry
menus) vs MPS validity (memory budget) lives in the device client.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api import annotations as ann
from nos_tpu_torch.api.objects import Node
from nos_tpu_torch.api.resources import compute_pod_request
from nos_tpu_torch.cluster.client import Cluster, Event, EventType, NotFoundError
from nos_tpu_torch.controllers.tpu_agent import SharedState
from nos_tpu_torch.gpu.mig import MigProfile, geometry_feasible
from nos_tpu_torch.gpu.mps import MpsGpu, MpsProfile
from nos_tpu_torch.tpulib.interface import TpuLibError
from nos_tpu_torch.util import pod as podutil

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class GpuDevice:
    device_id: str
    gpu_index: int
    profile: str
    in_use: bool = False


class FakeGpuDeviceClient:
    """In-memory MIG/MPS device control (the NVML / CUDA-MPS mock analog,
    pkg/test/mocks). `validate(gpu_index, geometry)` enforces mode rules."""

    def __init__(
        self,
        gpu_count: int,
        validate: Callable[[int, Dict[str, int]], bool],
        fail_next: int = 0,
    ):
        self.gpu_count = gpu_count
        self._validate = validate
        self._devices: Dict[str, GpuDevice] = {}
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self.fail_next = fail_next

    def _geometry(self, gpu_index: int) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self._devices.values():
            if d.gpu_index == gpu_index:
                out[d.profile] = out.get(d.profile, 0) + 1
        return out

    def list_devices(self) -> List[GpuDevice]:
        with self._lock:
            return sorted(self._devices.values(), key=lambda d: d.device_id)

    def create_device(self, gpu_index: int, profile: str) -> GpuDevice:
        with self._lock:
            if self.fail_next > 0:
                self.fail_next -= 1
                raise TpuLibError("injected failure: create_device")
            if not 0 <= gpu_index < self.gpu_count:
                raise TpuLibError(f"no gpu {gpu_index}")
            trial = self._geometry(gpu_index)
            trial[profile] = trial.get(profile, 0) + 1
            if not self._validate(gpu_index, trial):
                raise TpuLibError(
                    f"geometry {trial} invalid on gpu {gpu_index}"
                )
            d = GpuDevice(f"dev-{next(self._ids)}", gpu_index, profile)
            self._devices[d.device_id] = d
            return d

    def delete_device(self, device_id: str) -> None:
        with self._lock:
            d = self._devices.get(device_id)
            if d is None:
                raise TpuLibError(f"no such device {device_id}")
            if d.in_use:
                raise TpuLibError(f"device {device_id} in use")
            del self._devices[device_id]

    def delete_all_except(self, keep_ids: List[str]) -> List[str]:
        with self._lock:
            deleted = []
            for did in list(self._devices):
                if did not in keep_ids and not self._devices[did].in_use:
                    del self._devices[did]
                    deleted.append(did)
            return deleted

    def set_in_use(self, device_id: str, in_use: bool) -> None:
        with self._lock:
            d = self._devices[device_id]
            self._devices[device_id] = GpuDevice(d.device_id, d.gpu_index, d.profile, in_use)


def mig_validator(model: str) -> Callable[[int, Dict[str, int]], bool]:
    def validate(gpu_index: int, geometry: Dict[str, int]) -> bool:
        # NVML semantics: devices are created one at a time, so every
        # INTERMEDIATE state must pass — feasibility (sub-multiset of an
        # allowed geometry), not full-menu membership.
        return geometry_feasible(
            model, {MigProfile.parse(p): n for p, n in geometry.items()}
        )

    return validate


def mps_validator(memory_gb: int) -> Callable[[int, Dict[str, int]], bool]:
    def validate(gpu_index: int, geometry: Dict[str, int]) -> bool:
        total = sum(MpsProfile.parse(p).memory_gb * n for p, n in geometry.items())
        return total <= memory_gb

    return validate


def _split_hybrid_geometry(geometry: Dict[str, int]):
    """Partition a mixed profile multiset by mode ('1g.5gb' is MIG,
    '10gb' is MPS); raises ValueError on a profile neither mode parses."""
    mig_part: Dict[MigProfile, int] = {}
    mps_part: Dict[MpsProfile, int] = {}
    for p, n in geometry.items():
        try:
            mig_part[MigProfile.parse(p)] = n
        except ValueError:
            mps_part[MpsProfile.parse(p)] = n
    return mig_part, mps_part


def hybrid_validator(
    model: str, memory_gb: int
) -> Callable[[int, Dict[str, int]], bool]:
    """Device rules for a hybrid node (constants.KIND_HYBRID): each GPU is
    EITHER MIG-partitioned OR MPS-sliced, never both — MIG is a per-GPU
    hardware mode on NVIDIA silicon, so hybrid means mixing modes across a
    node's GPUs, not within one. A single-mode geometry then follows that
    mode's own rules (menu feasibility / memory budget)."""

    def validate(gpu_index: int, geometry: Dict[str, int]) -> bool:
        try:
            mig_part, mps_part = _split_hybrid_geometry(geometry)
        except ValueError:
            return False
        if mig_part and mps_part:
            return False
        if mig_part:
            return geometry_feasible(model, mig_part)
        total = sum(p.memory_gb * n for p, n in mps_part.items())
        return total <= memory_gb

    return validate


def hybrid_parse_profile(resource_name: str):
    """Pod-request resource -> profile, either mode (hybrid agent)."""
    return MigProfile.from_resource(resource_name) or MpsProfile.from_resource(
        resource_name
    )


def hybrid_resource_of(profile: str) -> str:
    """Profile name -> extended-resource name, either mode (hybrid agent)."""
    try:
        return MigProfile.parse(profile).resource
    except ValueError:
        return MpsProfile.parse(profile).resource


class GpuAgent:
    """Node daemon applying/reporting per-GPU slice geometry."""

    def __init__(
        self,
        cluster: Cluster,
        node_name: str,
        client: FakeGpuDeviceClient,
        parse_profile: Callable[[str], Optional[object]] = MigProfile.from_resource,
        resource_of: Callable[[str], str] = lambda p: f"{constants.RESOURCE_MIG_PREFIX}{p}",
        plugin_client: Optional[object] = None,
        pod_resources_lister: Optional[object] = None,
    ):
        self.cluster = cluster
        self.node_name = node_name
        self.client = client
        self.parse_profile = parse_profile
        self.resource_of = resource_of
        self.plugin_client = plugin_client
        self.pod_resources_lister = pod_resources_lister
        self.shared = SharedState()
        self._apply_changed = False
        self._unsub = None

    # -- lifecycle ----------------------------------------------------------
    def startup(self) -> None:
        self.sync_usage_from_pods()
        used = [d.device_id for d in self.client.list_devices() if d.in_use]
        deleted = self.client.delete_all_except(used)
        if deleted:
            logger.info("gpuagent %s: startup cleanup removed %s", self.node_name, deleted)
        self.report()

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
        from the device client."""
        if self.pod_resources_lister is not None:
            return self.pod_resources_lister
        from nos_tpu_torch.cluster.pod_resources import GpuPodResources

        return GpuPodResources(self.client, self.resource_of)

    # -- usage sync ----------------------------------------------------------
    def sync_usage_from_pods(self) -> None:
        demand: Dict[str, int] = {}
        for pod in self.cluster.list(
            "Pod", predicate=lambda p: p.spec.node_name == self.node_name
        ):
            if not podutil.is_active(pod):
                continue
            for res, qty in compute_pod_request(pod).items():
                profile = self.parse_profile(res)
                if profile is not None and qty > 0:
                    demand[str(profile)] = demand.get(str(profile), 0) + int(round(qty))
        for d in self.client.list_devices():
            want_used = demand.get(d.profile, 0) > 0
            if want_used:
                demand[d.profile] -= 1
            if d.in_use != want_used:
                self.client.set_in_use(d.device_id, want_used)

    # -- actuator ------------------------------------------------------------
    def reconcile(self) -> None:
        node = self.cluster.try_get("Node", "", self.node_name)
        if node is None:
            return
        specs = ann.parse_spec(node.metadata.annotations)
        self.shared.last_parsed_plan_id = ann.get_spec_plan(node.metadata.annotations)
        desired: Dict[Tuple[int, str], int] = {}
        for s in specs:
            if s.quantity > 0:
                desired[(s.device_index, s.profile)] = s.quantity
        self.sync_usage_from_pods()
        holds = ann.get_migration_hold(node.metadata.annotations)
        # Mutation flag survives a mid-apply exception: devices already
        # deleted/created before the failure still require a plugin restart.
        self._apply_changed = False
        try:
            self._apply(desired, holds)
        except TpuLibError:
            logger.exception("gpuagent %s: apply failed; reporting actual state", self.node_name)
        changed = self._apply_changed
        if changed and self.plugin_client is not None:
            # Force the device plugin to re-register the new device set with
            # the kubelet (migagent actuator.go:205-209 restart path).
            # reconcile runs inside a Node watch dispatch (bus lock held), so
            # any waiting must happen off-thread.
            try:
                self.plugin_client.restart(self.node_name, wait="background")
            except Exception:  # noqa: BLE001
                logger.exception("gpuagent %s: device-plugin restart failed", self.node_name)
        self.shared.on_apply()
        self.report()

    def _apply(
        self,
        desired: Dict[Tuple[int, str], int],
        holds: Optional[Dict[str, int]] = None,
    ) -> None:
        """Diff-apply the desired geometry; sets self._apply_changed when any
        device is created or deleted (the device plugin must then
        re-register) — a flag rather than a return value so mutations that
        precede a mid-apply failure still trigger the restart.

        Per GPU: delete surplus free devices (never used ones — and never a
        `holds`-protected free device: an in-flight migration's destination
        counts as used until the mover rebinds, the delete-free-first ladder
        extended to moves), then create the missing profiles. Device
        creation can be order-sensitive (MIG placement constraints), so when
        creating we (a) also delete + recreate the GPU's surviving *free*
        devices to widen the space of valid creation orders
        (plan/plan.go:94-109 extractResourcesToRecreate) and (b) try bounded
        distinct permutations of the creation order with cleanup between
        attempts (nvml/client.go:225-340)."""
        holds = dict(holds or {})
        current: Dict[Tuple[int, str], List[GpuDevice]] = {}
        for d in self.client.list_devices():
            current.setdefault((d.gpu_index, d.profile), []).append(d)
        gpu_indices = sorted(
            {gi for gi, _ in current} | {gi for gi, _ in desired}
        )
        for gpu_index in gpu_indices:
            # Delete surplus (free first, never used, never held).
            for (gi, profile), devices in sorted(current.items()):
                if gi != gpu_index:
                    continue
                surplus = len(devices) - desired.get((gi, profile), 0)
                free = [d for d in devices if not d.in_use]
                held = holds.get(profile, 0)
                for d in free[held:held + max(0, surplus)]:
                    self.client.delete_device(d.device_id)
                    self._apply_changed = True
            # Creates still missing on this GPU.
            have: Dict[str, int] = {}
            for d in self.client.list_devices():
                if d.gpu_index == gpu_index:
                    have[d.profile] = have.get(d.profile, 0) + 1
            creates: List[str] = []
            for (gi, profile), want in sorted(desired.items()):
                if gi == gpu_index:
                    creates.extend([profile] * max(0, want - have.get(profile, 0)))
            if not creates:
                continue
            # Recreate surviving free devices alongside the new ones; held
            # devices stay put — a recreate window is a deletion window.
            spare = dict(holds)
            for d in sorted(
                self.client.list_devices(), key=lambda d: d.device_id
            ):
                if d.gpu_index == gpu_index and not d.in_use:
                    if spare.get(d.profile, 0) > 0:
                        spare[d.profile] -= 1
                        continue
                    self.client.delete_device(d.device_id)
                    creates.append(d.profile)
                    self._apply_changed = True
            self._create_with_permutations(gpu_index, creates)

    MAX_CREATE_PERMUTATIONS = 20  # nvml/client.go:286-331 attempt bound

    def _create_with_permutations(self, gpu_index: int, creates: List[str]) -> None:
        """Create `creates` on the GPU, retrying distinct creation orders with
        cleanup on failure; falls back to best-effort partial creation.
        Descending-first enumeration: large-profile-first orders are the ones
        placement constraints tend to admit, so they must not sit behind the
        attempt bound."""
        from nos_tpu_torch.util import distinct_permutations

        for attempt, order in enumerate(distinct_permutations(creates, reverse=True)):
            if attempt >= self.MAX_CREATE_PERMUTATIONS:
                break
            made: List[GpuDevice] = []
            try:
                for profile in order:
                    made.append(self.client.create_device(gpu_index, profile))
                self._apply_changed = True
                return
            except TpuLibError:
                for d in made:
                    try:
                        self.client.delete_device(d.device_id)
                    except TpuLibError:
                        logger.exception(
                            "gpuagent %s: cleanup of %s failed", self.node_name, d.device_id
                        )
        # No full ordering worked: apply partially (the reference's plan-level
        # partial apply; the reporter will publish the actual state).
        for profile in sorted(creates, reverse=True):
            try:
                self.client.create_device(gpu_index, profile)
                self._apply_changed = True
            except TpuLibError:
                logger.warning(
                    "gpuagent %s: create %s on gpu %d failed (partial apply)",
                    self.node_name,
                    profile,
                    gpu_index,
                )

    # -- reporter ------------------------------------------------------------
    def report(self) -> None:
        self.sync_usage_from_pods()
        per_gpu: Dict[int, Dict[str, List[GpuDevice]]] = {}
        for d in self.client.list_devices():
            per_gpu.setdefault(d.gpu_index, {}).setdefault(d.profile, []).append(d)

        statuses = []
        resources: Dict[str, float] = {}
        for gpu_index, profiles in sorted(per_gpu.items()):
            geometry = {p: len(ds) for p, ds in profiles.items()}
            used = {p: sum(1 for d in ds if d.in_use) for p, ds in profiles.items()}
            statuses.extend(ann.status_from_geometry(gpu_index, geometry, used))
            for p, n in geometry.items():
                resource = self.resource_of(p)
                resources[resource] = resources.get(resource, 0.0) + n

        desired_status = dict(ann.format_status(statuses))
        if self.shared.last_parsed_plan_id is not None:
            desired_status[constants.ANNOTATION_STATUS_PLAN] = (
                self.shared.last_parsed_plan_id
            )

        def unchanged(node: Node) -> bool:
            """Periodic reports must not churn the watch bus: skip the patch
            when status annotations and exposed resources already match."""
            current_status = {
                k: v
                for k, v in node.metadata.annotations.items()
                if constants.ANNOTATION_STATUS_REGEX.match(k)
                or k == constants.ANNOTATION_STATUS_PLAN
            }
            if current_status != desired_status:
                return False
            current_res = {
                r: node.status.allocatable[r]
                for r in node.status.allocatable
                if constants.RESOURCE_MIG_REGEX.match(r)
                or constants.RESOURCE_MPS_REGEX.match(r)
            }
            return current_res == {k: float(v) for k, v in resources.items()}

        def mutate(node: Node) -> None:
            ann.strip_status_annotations(node.metadata.annotations)
            if self.shared.last_parsed_plan_id is None:
                # A stale plan id from a previous agent run would otherwise
                # survive every rewrite and keep unchanged() false forever.
                node.metadata.annotations.pop(constants.ANNOTATION_STATUS_PLAN, None)
            node.metadata.annotations.update(desired_status)
            for res in [
                r
                for r in node.status.allocatable
                if constants.RESOURCE_MIG_REGEX.match(r)
                or constants.RESOURCE_MPS_REGEX.match(r)
            ]:
                del node.status.allocatable[res]
            for res, n in resources.items():
                node.status.allocatable[res] = n

        try:
            node = self.cluster.try_get("Node", "", self.node_name)
            if node is None:
                return
            if not unchanged(node):
                self.cluster.patch("Node", "", self.node_name, mutate)
        except NotFoundError:
            return
        self.shared.on_report()
