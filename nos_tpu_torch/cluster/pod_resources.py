"""Port of `nos_tpu/cluster/pod_resources.py` (:1-83): `DeviceEntry` (:22),
`PodResourcesLister` (:35), `TpuPodResources` (:43), `GpuPodResources`
(:64). Copied verbatim; only the imports point at the port, which imports
nothing of the JAX package.

Device accounting: the kubelet pod-resources API seam.

The reference discovers which accelerator devices exist and which are in use
through the kubelet's pod-resources gRPC socket (pkg/resource/client.go:26-87
`GetAllocatableDevices` / `GetUsedDevices`, lister.go:14-24), returning flat
`{ResourceName, DeviceId, Status}` records that the MIG/MPS clients join with
NVML state. This module is that seam for the in-process runtime: the same
two-call API, backed by the node agents' device clients, so controllers and
tests consume device accounting through one interface regardless of mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Protocol

STATUS_USED = "used"
STATUS_FREE = "free"


@dataclass(frozen=True)
class DeviceEntry:
    """One device as the pod-resources API reports it
    (pkg/resource/device.go analog)."""

    resource_name: str
    device_id: str
    status: str  # STATUS_USED | STATUS_FREE

    @property
    def is_used(self) -> bool:
        return self.status == STATUS_USED


class PodResourcesLister(Protocol):
    def get_allocatable_devices(self) -> List[DeviceEntry]:
        """Every device the node exposes (used and free)."""

    def get_used_devices(self) -> List[DeviceEntry]:
        """Devices currently allocated to a pod."""


class TpuPodResources:
    """Accounting over a TpuClient's carved sub-slices: one device per slice,
    resource name = the slice profile's extended resource."""

    def __init__(self, client):
        self._client = client

    def get_allocatable_devices(self) -> List[DeviceEntry]:
        return [
            DeviceEntry(
                resource_name=s.profile.resource,
                device_id=s.slice_id,
                status=STATUS_USED if s.in_use else STATUS_FREE,
            )
            for s in sorted(self._client.list_slices(), key=lambda s: s.slice_id)
        ]

    def get_used_devices(self) -> List[DeviceEntry]:
        return [d for d in self.get_allocatable_devices() if d.is_used]


class GpuPodResources:
    """Accounting over a MIG/MPS device client; `resource_of` maps a profile
    name to its extended resource (the same hook the GpuAgent reports with)."""

    def __init__(self, client, resource_of: Callable[[str], str]):
        self._client = client
        self._resource_of = resource_of

    def get_allocatable_devices(self) -> List[DeviceEntry]:
        return [
            DeviceEntry(
                resource_name=self._resource_of(d.profile),
                device_id=d.device_id,
                status=STATUS_USED if d.in_use else STATUS_FREE,
            )
            for d in self._client.list_devices()
        ]

    def get_used_devices(self) -> List[DeviceEntry]:
        return [d for d in self.get_allocatable_devices() if d.is_used]
