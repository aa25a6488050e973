"""Port of `nos_tpu/scheduler/plugins/noderesources.py:1` (:1-106):
`NodeSelectorFilter` (:16), `NodeResourcesFit` (:26), `EndAlignedScore`
(:51), `LeastAllocatedScore` (:92). Copied verbatim; only the imports point
at the port, which imports nothing of the JAX package.

Baseline fit + selector filters and a least-allocated score
(the stock-plugin subset the reference relies on: NodeResourcesFit etc.)."""

from __future__ import annotations

import math
from typing import Callable

from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.partitioning.core.interface import NodeInfo
from nos_tpu_torch.scheduler.framework import CycleState, FilterPlugin, ScorePlugin, Status
from nos_tpu_torch.util import pod as podutil


class NodeSelectorFilter(FilterPlugin):
    name = "NodeSelector"

    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        for k, v in pod.spec.node_selector.items():
            if node.labels.get(k) != v:
                return Status.unschedulable(f"node selector {k}={v} not satisfied")
        return Status.success()


class NodeResourcesFit(FilterPlugin):
    name = "NodeResourcesFit"

    def __init__(self, request_fn: Callable[[Pod], ResourceList]):
        self.request_fn = request_fn

    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        from nos_tpu_torch import constants

        request = self.request_fn(pod)
        free = node.free
        lacking = [
            f"{r} (want {q:g}, free {free.get(r, 0.0):g})"
            for r, q in request.items()
            # The synthetic accelerator-memory resource is metered against
            # quotas, never against nodes (resource.go gpu-memory semantics).
            if r != constants.RESOURCE_ACCELERATOR_MEMORY
            and q > 0
            and q > free.get(r, 0.0) + 1e-9
        ]
        if lacking:
            return Status.unschedulable("insufficient " + ", ".join(lacking))
        return Status.success()


class EndAlignedScore(ScorePlugin):
    """Co-locate workloads whose expected ends are close (0-30).

    Duration-aware packing for the drain problem: when long and short jobs
    interleave freely, every node's drain time is the max of its occupants'
    ends, so no node ever fully drains and pod-scale workloads strand (the
    p95 tail in docs/dynamic-partitioning.md). Aligning ends makes nodes
    drain in waves — whole nodes free up, without refusing anybody
    placement. Pods or nodes without duration stamps score 0 (neutral)."""

    name = "EndAligned"

    def __init__(self, now, scale_s: float = 180.0):
        self._now = now
        self.scale_s = scale_s

    def _node_end(self, node: NodeInfo, now: float):
        """Latest stamped end among the node's occupants (None: unknown).
        Memoized on the NodeInfo itself (keyed by occupant count) — node
        snapshots are per-pass objects, and this runs for every
        (pending pod x feasible node) pair on the scheduling hot path. An
        evict-then-bind netting the same count can serve one pass of stale
        alignment signal; that is fine for a score heuristic."""
        cached = getattr(node, "_end_aligned_cache", None)
        if cached is not None and cached[0] == len(node.pods):
            return cached[1]
        node_end = podutil.latest_expected_end(node.pods, now)
        node._end_aligned_cache = (len(node.pods), node_end)
        return node_end

    def score(self, state: CycleState, pod: Pod, node: NodeInfo) -> float:
        duration = podutil.expected_duration_s(pod)
        if duration is None:
            return 0.0
        now = self._now()
        node_end = self._node_end(node, now)
        if node_end is None:
            return 0.0  # unknown occupant: no alignment signal
        return 30.0 * math.exp(-abs(node_end - (now + duration)) / self.scale_s)


class LeastAllocatedScore(ScorePlugin):
    """Prefer emptier nodes (spreading) for non-accelerator resources."""

    name = "LeastAllocated"

    def score(self, state: CycleState, pod: Pod, node: NodeInfo) -> float:
        total = 0.0
        count = 0
        for resource in ("cpu", "memory"):
            alloc = node.allocatable.get(resource, 0.0)
            if alloc <= 0:
                continue
            total += max(0.0, 1.0 - node.requested.get(resource, 0.0) / alloc)
            count += 1
        return 10.0 * total / count if count else 0.0
