"""Port of `nos_tpu/tpulib/interface.py` (:1-53): `TpuLibError` (:11),
`SliceHandle` (:16), `TpuClient` (:26). Copied verbatim; only the imports
point at the port, which imports nothing of the JAX package.

TpuClient interface (pkg/gpu/nvml/interface.go:23-35 analog)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Tuple

from nos_tpu_torch.tpu import Profile, Topology


class TpuLibError(Exception):
    """Device-layer failure (the typed-errors analog of pkg/gpu/errors.go)."""


@dataclass(frozen=True)
class SliceHandle:
    """One carved sub-slice as the device layer sees it."""

    slice_id: str
    profile: Profile
    origin: Tuple[int, ...]
    dims: Tuple[int, ...]
    in_use: bool = False


class TpuClient(Protocol):
    """Node-local TPU control: topology discovery and sub-slice lifecycle.

    Mirrors nvml.Client (GetMigEnabledGPUs / CreateMigDevices / DeleteMigDevice
    / DeleteAllMigDevicesExcept, client.go:148-454) with TPU vocabulary."""

    def get_topology(self) -> Topology: ...

    def list_slices(self) -> List[SliceHandle]: ...

    def create_slice(
        self, profile: Profile, origin: Tuple[int, ...], dims: Tuple[int, ...]
    ) -> SliceHandle: ...

    def delete_slice(self, slice_id: str) -> None: ...

    def delete_all_except(self, keep_ids: List[str]) -> List[str]:
        """Crash-recovery cleanup (cmd/migagent/migagent.go:190-199 analog):
        delete every slice not in keep_ids, returning deleted ids."""
        ...

    def set_slice_in_use(self, slice_id: str, in_use: bool) -> None:
        """Mark a slice as holding a workload (the pod-resources signal)."""
        ...

    def health(self) -> Optional[str]:
        """None when healthy, else a reason string."""
        ...
