"""Port of `nos_tpu/analysis/checkers/__init__.py:1` (:1-52). Copied near
verbatim; the imports point at the port, which imports nothing of the JAX
package.

Checker registry. Adding a checker = write the module, list it here,
document it in docs/static-analysis.md."""

from __future__ import annotations

from typing import List

from nos_tpu_torch.analysis.core import Checker


def all_checkers() -> List[Checker]:
    from nos_tpu_torch.analysis.checkers.block_discipline import BlockDisciplineChecker
    from nos_tpu_torch.analysis.checkers.cost_discipline import CostDisciplineChecker
    from nos_tpu_torch.analysis.checkers.device_placement import DevicePlacementChecker
    from nos_tpu_torch.analysis.checkers.donation_discipline import DonationDisciplineChecker
    from nos_tpu_torch.analysis.checkers.exception_hygiene import ExceptionHygieneChecker
    from nos_tpu_torch.analysis.checkers.fault_discipline import FaultDisciplineChecker
    from nos_tpu_torch.analysis.checkers.host_sync import HostSyncChecker
    from nos_tpu_torch.analysis.checkers.lock_discipline import LockDisciplineChecker
    from nos_tpu_torch.analysis.checkers.protocol_roundtrip import ProtocolRoundTripChecker
    from nos_tpu_torch.analysis.checkers.quant_discipline import QuantDisciplineChecker
    from nos_tpu_torch.analysis.checkers.radix_discipline import RadixDisciplineChecker
    from nos_tpu_torch.analysis.checkers.replay_purity import ReplayPurityChecker
    from nos_tpu_torch.analysis.checkers.spill_discipline import SpillDisciplineChecker
    from nos_tpu_torch.analysis.checkers.staging_discipline import StagingDisciplineChecker
    from nos_tpu_torch.analysis.checkers.store_discipline import StoreDisciplineChecker
    from nos_tpu_torch.analysis.checkers.telemetry_schema import TelemetrySchemaChecker
    from nos_tpu_torch.analysis.checkers.trace_discipline import TraceDisciplineChecker
    from nos_tpu_torch.analysis.checkers.trace_safety import TraceSafetyChecker
    from nos_tpu_torch.analysis.checkers.wire_literals import WireLiteralChecker

    return [
        WireLiteralChecker(),
        ProtocolRoundTripChecker(),
        ExceptionHygieneChecker(),
        LockDisciplineChecker(),
        TraceSafetyChecker(),
        HostSyncChecker(),
        BlockDisciplineChecker(),
        FaultDisciplineChecker(),
        SpillDisciplineChecker(),
        RadixDisciplineChecker(),
        StagingDisciplineChecker(),
        DevicePlacementChecker(),
        TraceDisciplineChecker(),
        CostDisciplineChecker(),
        StoreDisciplineChecker(),
        DonationDisciplineChecker(),
        ReplayPurityChecker(),
        TelemetrySchemaChecker(),
        QuantDisciplineChecker(),
    ]
