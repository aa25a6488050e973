"""Port of `nos_tpu/partitioning/core/actuator.py:1` (:1-97): `Actuator` (:34).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Actuator: diff desired vs current partitioning and drive the mode
partitioner (core/actuator.go:39-66 analog).

For plans carrying slice migrations the apply is ORDERED — the move
protocol: (1) create-destination: every migration's destination node is
applied first, so the mover's replacement slice exists before anything is
torn down; (2) drain: the mover pods are evicted (their controllers resubmit
and the scheduler rebinds them into the reserved destination); (3)
delete-source: only then do the remaining nodes — including every migration
source, whose new geometry lacks the mover's slice — get applied. Step 3
composes with the agents' existing delete-free-first / never-delete-used
ladder: the source slice is only free (hence deletable) because step 2
already drained it, and a mid-flight race (the mover pod still active when
the source spec lands) degrades to the agent's partial apply, never to a
used-slice deletion.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from nos_tpu_torch.partitioning.core.interface import (
    NodePartitioning,
    Partitioner,
    PartitioningState,
    partitioning_equal,
)
from nos_tpu_torch.partitioning.core.planner import PartitioningPlan

logger = logging.getLogger(__name__)


class Actuator:
    def __init__(
        self,
        partitioner: Partitioner,
        get_current: Callable[[str], NodePartitioning],
        evict: Optional[Callable[..., None]] = None,
    ):
        self._partitioner = partitioner
        self._get_current = get_current
        # Drain channel for the move protocol (the controller's _evict).
        # None = migrations cannot be actuated; plans carrying them fail
        # loudly instead of applying an un-ordered (unsafe) state.
        self._evict = evict

    def apply(self, plan: PartitioningPlan) -> Dict[str, bool]:
        """Apply the plan node by node, skipping nodes whose current
        partitioning already equals the desired one. Plans with migrations
        apply in move-protocol order (destinations, drain, sources). Returns
        node -> whether it was (re)partitioned."""
        applied: Dict[str, bool] = {}
        if plan.migrations:
            if self._evict is None:
                raise RuntimeError(
                    "plan carries migrations but the actuator has no evict "
                    "channel — refusing an un-ordered apply"
                )
            dest_names = sorted({m.dest_node for m in plan.migrations})
            # 1. Create destinations.
            for node_name in dest_names:
                if node_name in plan.state:
                    applied[node_name] = self._apply_node(
                        plan, node_name, plan.state[node_name]
                    )
            # 2. Drain the movers (ordered, deterministic).
            for migration in sorted(
                plan.migrations, key=lambda m: m.pod_key
            ):
                logger.info(
                    "actuator: draining mover %s (%s -> %s, plan %s)",
                    migration.pod_key,
                    migration.source_node,
                    migration.dest_node,
                    plan.id,
                )
                self._evict(migration.pod)
            # 3. Delete sources (fall through to the normal sweep below —
            #    destinations are already recorded in `applied` and skipped).
        for node_name in sorted(plan.state):
            if node_name in applied:
                continue
            applied[node_name] = self._apply_node(
                plan, node_name, plan.state[node_name]
            )
        return applied

    def _apply_node(
        self, plan: PartitioningPlan, node_name: str, desired: NodePartitioning
    ) -> bool:
        current = self._get_current(node_name)
        if partitioning_equal(current, desired):
            return False
        logger.info("actuator: applying plan %s to node %s", plan.id, node_name)
        self._partitioner.apply_partitioning(node_name, plan.id, desired)
        return True
