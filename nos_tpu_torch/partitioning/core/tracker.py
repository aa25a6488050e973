"""Port of `nos_tpu/partitioning/core/tracker.py:1` (:1-63): `SliceTracker`
(:13). Copied verbatim; only the imports point at the port, which imports
nothing of the JAX package.

SliceTracker: per-batch accounting of requested & lacking slices
(core/tracker.go:26-88 analog)."""

from __future__ import annotations

from typing import Dict, Iterable, List

from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.partitioning.core.interface import SliceSpec


class SliceTracker:
    """Tracks, across a planning batch, how many slices the pending pods still
    need that the cluster cannot currently provide. Decremented as pods are
    placed so the planner can stop early (planner.go:66-70)."""

    def __init__(self, snapshot, pods: Iterable[Pod], slice_spec: SliceSpec):
        self._spec = slice_spec
        self._requested: Dict[str, ResourceList] = {}
        self._lacking: Dict[str, ResourceList] = {}
        # Pods with an in-flight migration reservation are already accounted
        # on their destination node (snapshot taker marks the capacity used):
        # counting them lacking would carve a second slice for the same pod
        # — the double-claim the reservation protocol forbids.
        reserved = getattr(snapshot, "reserved_pod_keys", frozenset())
        for pod in pods:
            key = pod.metadata.namespaced_name
            if key in reserved:
                continue
            req = slice_spec.pod_slice_request(pod)
            if not req:
                continue
            self._requested[key] = req
            lacking = snapshot.get_lacking_slices(pod)
            if lacking:
                self._lacking[key] = lacking

    @property
    def is_empty(self) -> bool:
        return not self._lacking

    def remaining_pods(self) -> List[str]:
        return sorted(self._lacking)

    def get_lacking(self) -> ResourceList:
        """Aggregate lacking slices across not-yet-placed pods — the demand
        the planner feeds to update_geometry_for."""
        out = ResourceList()
        for rl in self._lacking.values():
            out = out.add(rl)
        return out

    def get_requested(self) -> ResourceList:
        out = ResourceList()
        for rl in self._requested.values():
            out = out.add(rl)
        return out

    def remove(self, pod: Pod) -> None:
        key = pod.metadata.namespaced_name
        self._requested.pop(key, None)
        self._lacking.pop(key, None)
