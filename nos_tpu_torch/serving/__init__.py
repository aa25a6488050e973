"""The port's serving-plane pieces so far: the per-tenant cost ledger."""

from nos_tpu_torch.serving.accounting import CostLedger

__all__ = ["CostLedger"]
