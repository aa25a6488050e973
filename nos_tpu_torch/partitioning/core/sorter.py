"""Port of `nos_tpu/partitioning/core/sorter.py:1` (:1-29):
`sort_candidate_pods` (:16). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

Candidate-pod ordering (core/util.go:34-71 analog).

Priority first (higher scheduled earlier), then pods requesting *smaller*
slices first — placing small slices first maximizes the number of pods a
geometry can satisfy — then creation time and name for determinism.
"""

from __future__ import annotations

from typing import List

from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.partitioning.core.interface import SliceSpec


def sort_candidate_pods(pods: List[Pod], slice_spec: SliceSpec) -> List[Pod]:
    def slice_size(pod: Pod) -> float:
        req = slice_spec.pod_slice_request(pod)
        return sum(slice_spec.slice_weight(r) * q for r, q in req.items())

    return sorted(
        pods,
        key=lambda p: (
            -p.spec.priority,
            slice_size(p),
            p.metadata.creation_timestamp,
            p.metadata.namespaced_name,
        ),
    )
