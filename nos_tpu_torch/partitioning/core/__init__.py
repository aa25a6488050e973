"""Port of `nos_tpu/partitioning/core/__init__.py:1` (:1-13). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package."""

from nos_tpu_torch.partitioning.core.interface import (  # noqa: F401
    NodeInfo,
    PartitionableNode,
    Partitioner,
    SimScheduler,
    SliceSpec,
    SnapshotTaker,
)
from nos_tpu_torch.partitioning.core.snapshot import Snapshot  # noqa: F401
from nos_tpu_torch.partitioning.core.tracker import SliceTracker  # noqa: F401
from nos_tpu_torch.partitioning.core.sorter import sort_candidate_pods  # noqa: F401
from nos_tpu_torch.partitioning.core.planner import Planner, PartitioningPlan  # noqa: F401
from nos_tpu_torch.partitioning.core.actuator import Actuator  # noqa: F401
