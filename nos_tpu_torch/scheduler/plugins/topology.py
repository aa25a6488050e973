"""Port of `nos_tpu/scheduler/plugins/topology.py:1` (:1-129):
`TpuTopologyFilter` (:47), `TpuTopologyScore` (:95). Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

TPU topology-aware scoring.

The TPU-native plugin the north star asks for (BASELINE.json): bin-pack
fractional-TPU pods onto nodes so that (a) already-carved free slices are
consumed before any node re-carves, (b) accelerator capacity is packed tightly
(leaving whole meshes free for future large ICI-hungry jobs), and (c) a node
whose free mesh can't host the requested sub-slice contiguously is filtered
out even when raw chip counts would fit.
"""

from __future__ import annotations

from typing import Dict, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import compute_pod_request
from nos_tpu_torch.partitioning.core.interface import NodeInfo
from nos_tpu_torch.scheduler.framework import CycleState, FilterPlugin, ScorePlugin, Status
from nos_tpu_torch.tpu import Profile, Topology
from nos_tpu_torch.tpu.packing import packable


def _requested_profiles(pod: Pod) -> Dict[Profile, int]:
    out: Dict[Profile, int] = {}
    for resource, qty in compute_pod_request(pod).items():
        profile = Profile.from_resource(resource)
        if profile is not None and qty > 0:
            out[profile] = out.get(profile, 0) + int(round(qty))
    return out


def _node_topology(node: NodeInfo) -> Optional[Topology]:
    return Topology.from_node_labels(node.labels)


def _node_free_slice_counts(node: NodeInfo) -> Dict[Profile, int]:
    free = node.free
    out = {}
    for resource, qty in free.items():
        profile = Profile.from_resource(resource)
        if profile is not None and qty > 0:
            out[profile] = int(qty)
    return out


class TpuTopologyFilter(FilterPlugin):
    """Reject nodes whose mesh cannot contiguously host the pod's sub-slices.

    The plain fit filter only counts scalars; here we re-check *shape*: all the
    pod's requested profiles, together with every other currently-allocated
    slice and reserved whole chips, must still pack onto the node's ICI mesh.
    """

    name = "TpuTopologyFilter"

    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        wanted = _requested_profiles(pod)
        if not wanted:
            return Status.success()
        topology = _node_topology(node)
        if topology is None:
            return Status.unschedulable("pod requests TPU sub-slices; node has no TPU mesh")
        for profile in wanted:
            if profile.shape.rank != topology.shape.rank or not any(
                o.fits_in(topology.shape) for o in profile.shape.orientations()
            ):
                return Status.unschedulable(
                    f"sub-slice {profile} does not fit mesh {topology.shape}"
                )
        # Shape-check the whole allocation picture: carved slices (all of them
        # — they exist on the mesh) + whole chips in use as units.
        carved: Dict[Profile, int] = {}
        for resource, qty in node.allocatable.items():
            profile = Profile.from_resource(resource)
            if profile is not None and qty > 0:
                carved[profile] = carved.get(profile, 0) + int(qty)
        unit = Profile.parse("x".join(["1"] * topology.shape.rank))
        reserved = int(node.requested.get(constants.RESOURCE_TPU, 0.0))
        trial = dict(carved)
        if reserved:
            trial[unit] = trial.get(unit, 0) + reserved
        free_counts = _node_free_slice_counts(node)
        for profile, want in wanted.items():
            uncovered = max(0, want - free_counts.get(profile, 0))
            if uncovered:
                trial[profile] = trial.get(profile, 0) + uncovered
        if not packable(topology.shape, trial):
            return Status.unschedulable(
                f"mesh {topology.shape} cannot contiguously host requested sub-slices"
            )
        return Status.success()


class TpuTopologyScore(ScorePlugin):
    """Tight-packing score, 0-100."""

    name = "TpuTopologyScore"

    def score(self, state: CycleState, pod: Pod, node: NodeInfo) -> float:
        wanted = _requested_profiles(pod)
        whole_chips = int(compute_pod_request(pod).get(constants.RESOURCE_TPU, 0.0))
        if not wanted and whole_chips == 0:
            return 0.0
        topology = _node_topology(node)
        if topology is None:
            return 0.0
        free_counts = _node_free_slice_counts(node)
        free = node.free

        score = 0.0
        # (a) Consuming already-carved free slices avoids geometry churn.
        if wanted:
            covered = sum(
                min(want, free_counts.get(profile, 0)) for profile, want in wanted.items()
            )
            total_want = sum(wanted.values())
            score += 40.0 * covered / total_want
        # (b) Tight packing: prefer nodes with the least leftover accelerator
        # capacity after placement (most-allocated for accelerators).
        free_chip_equiv = free.get(constants.RESOURCE_TPU, 0.0) + sum(
            p.chips * q for p, q in free_counts.items()
        )
        want_chips = float(
            whole_chips + sum(p.chips * q for p, q in wanted.items())
        )
        if free_chip_equiv > 0:
            score += 60.0 * min(1.0, want_chips / free_chip_equiv)
        return score
