"""The port's cluster serving plane (`nos_tpu/serving/__init__.py`): the
per-tenant cost ledger, the fleet KV store (`FleetKVStore`, mounted by an
engine through `StoreTier`), the replica registry (`ReplicaSet`), the
prefix-aware router (`PrefixRouter`), the drain and migrate protocol
(`drain_replica`, `migrate_replica`) and the fleet supervisor
(`FleetSupervisor`, with its seeded `ReplicaFaultInjector`). The fleet
monitor, phase disaggregation and the accounting module's fleet half are
not ported yet (ROADMAP.md queue A: Fleet)."""

from nos_tpu_torch.serving.accounting import CostLedger
from nos_tpu_torch.serving.drain import DrainReport, drain_replica, migrate_replica
from nos_tpu_torch.serving.kv_store import FleetKVStore, StoreTier
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet
from nos_tpu_torch.serving.router import PrefixRouter
from nos_tpu_torch.serving.supervisor import (
    FailoverReport,
    FleetSupervisor,
    ReplicaFaultInjector,
    ReplicaFaultSpec,
)

__all__ = [
    "CostLedger",
    "FleetKVStore", "StoreTier",
    "ReplicaHandle", "ReplicaSet",
    "PrefixRouter",
    "DrainReport", "drain_replica", "migrate_replica",
    "FailoverReport", "FleetSupervisor", "ReplicaFaultInjector", "ReplicaFaultSpec",
]
