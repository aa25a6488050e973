"""Port of `nos_tpu/scheduler/resource_calculator.py:1` (:1-58):
`ResourceCalculator` (:18). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

ResourceCalculator: pod requests with the synthetic accelerator-memory unit.

Analog of pkg/gpu/util/resource.go:28-86: Elastic Quotas meter heterogeneous
accelerator requests in a single resource (`tpu.nos/accelerator-memory`, GB):
whole TPU chips and TPU sub-slices contribute chips x per-chip HBM GB; whole
GPUs contribute a configured GB; MIG profiles parse their GB from the name;
MPS slices are sized by their `<N>gb` resource name.
"""

from __future__ import annotations

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.resources import ResourceList, compute_pod_request
from nos_tpu_torch.tpu import Profile


class ResourceCalculator:
    def __init__(
        self,
        tpu_chip_memory_gb: float = constants.DEFAULT_TPU_CHIP_MEMORY_GB,
        nvidia_gpu_memory_gb: float = constants.DEFAULT_GPU_MEMORY_GB,
    ):
        self.tpu_chip_memory_gb = tpu_chip_memory_gb
        self.nvidia_gpu_memory_gb = nvidia_gpu_memory_gb

    def accelerator_memory_gb(self, request: ResourceList) -> float:
        gb = 0.0
        for resource, qty in request.items():
            if qty <= 0:
                continue
            if resource == constants.RESOURCE_TPU:
                gb += qty * self.tpu_chip_memory_gb
                continue
            tpu_profile = Profile.from_resource(resource)
            if tpu_profile is not None:
                gb += qty * tpu_profile.chips * self.tpu_chip_memory_gb
                continue
            if resource == constants.RESOURCE_NVIDIA_GPU:
                gb += qty * self.nvidia_gpu_memory_gb
                continue
            mig = constants.RESOURCE_MIG_REGEX.match(resource)
            if mig:
                gb += qty * float(mig.group(2))
                continue
            mps = constants.RESOURCE_MPS_REGEX.match(resource)
            if mps:
                gb += qty * float(mps.group(1))
        return gb

    def compute_pod_request(self, pod: Pod) -> ResourceList:
        """Effective request + synthetic accelerator-memory
        (resource.go ComputePodRequest + gpu-memory injection)."""
        request = compute_pod_request(pod)
        gb = self.accelerator_memory_gb(request)
        if gb > 0:
            request[constants.RESOURCE_ACCELERATOR_MEMORY] = gb
        return request
