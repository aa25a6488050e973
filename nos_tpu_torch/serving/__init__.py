"""The port's cluster serving plane (`nos_tpu/serving/__init__.py`): the
accounting module (the per-tenant `CostLedger` and the fleet half,
`duty_cycle`, `fleet_utilization`, `utilization_block`), the fleet KV
store (`FleetKVStore`, mounted by an engine through `StoreTier`), the
replica registry (`ReplicaSet`), the prefix-aware router
(`PrefixRouter`), the drain and migrate protocol (`drain_replica`,
`migrate_replica`), the fleet supervisor (`FleetSupervisor`, with its
seeded `ReplicaFaultInjector`), phase-disaggregated serving
(`HandoffCoordinator`) and the fleet monitor (`FleetMonitor`, with
`SLOTarget`, `SLOTracker` and `PressureReport`)."""

from nos_tpu_torch.serving.accounting import (
    CostLedger,
    duty_cycle,
    fleet_utilization,
    utilization_block,
)
from nos_tpu_torch.serving.disagg import HandoffCoordinator
from nos_tpu_torch.serving.drain import DrainReport, drain_replica, migrate_replica
from nos_tpu_torch.serving.kv_store import FleetKVStore, StoreTier
from nos_tpu_torch.serving.monitor import FleetMonitor, PressureReport, SLOTarget, SLOTracker
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet
from nos_tpu_torch.serving.router import PrefixRouter
from nos_tpu_torch.serving.supervisor import (
    FailoverReport,
    FleetSupervisor,
    ReplicaFaultInjector,
    ReplicaFaultSpec,
)

__all__ = [
    "CostLedger", "duty_cycle", "fleet_utilization", "utilization_block",
    "HandoffCoordinator",
    "FleetKVStore", "StoreTier",
    "FleetMonitor", "PressureReport", "SLOTarget", "SLOTracker",
    "ReplicaHandle", "ReplicaSet",
    "PrefixRouter",
    "DrainReport", "drain_replica", "migrate_replica",
    "FailoverReport", "FleetSupervisor", "ReplicaFaultInjector", "ReplicaFaultSpec",
]
