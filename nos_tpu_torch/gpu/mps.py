"""Port of `nos_tpu/gpu/mps.py:1` (:1-155): `MpsProfile` (:25), `MpsGpu` (:60).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

MPS (memory-slicing) device domain model.

Analog of pkg/gpu/slicing/{profile.go, gpu.go:162-247}: a profile is a memory
size `<N>gb`; geometry is *freeform* — any multiset of slices fits as long as
the GPU's memory budget allows (no hardware menu, unlike MIG). Actuation goes
through the NVIDIA device-plugin ConfigMap rather than node annotations'
device layer (mps/partitioner.go:61-157).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Dict, Mapping, Optional

from nos_tpu_torch import constants

Geometry = Dict["MpsProfile", int]

MIN_SLICE_GB = 1  # slicing/constant.go:20-24


@total_ordering
@dataclass(frozen=True)
class MpsProfile:
    memory_gb: int

    @classmethod
    def parse(cls, name: str) -> "MpsProfile":
        """Parse '10gb' or 'nvidia.com/gpu-10gb'."""
        if name.startswith(constants.RESOURCE_MPS_PREFIX):
            name = name[len(constants.RESOURCE_MPS_PREFIX):]
        if not name.endswith("gb"):
            raise ValueError(f"invalid MPS profile {name!r}")
        gb = int(name[:-2])
        if gb < MIN_SLICE_GB:
            raise ValueError(f"MPS slice must be >= {MIN_SLICE_GB}GB")
        return cls(gb)

    @classmethod
    def from_resource(cls, resource_name: str) -> Optional["MpsProfile"]:
        m = constants.RESOURCE_MPS_REGEX.match(resource_name)
        return cls(int(m.group(1))) if m else None

    @property
    def name(self) -> str:
        return f"{self.memory_gb}gb"

    @property
    def resource(self) -> str:
        return f"{constants.RESOURCE_MPS_PREFIX}{self.name}"

    def __lt__(self, other: "MpsProfile") -> bool:
        return self.memory_gb < other.memory_gb

    def __str__(self) -> str:
        return self.name


class MpsGpu:
    """One MPS-sliced GPU with a memory budget (slicing/gpu.go analog)."""

    def __init__(
        self,
        memory_gb: int,
        index: int,
        geometry: Optional[Mapping[MpsProfile, int]] = None,
        used: Optional[Mapping[MpsProfile, int]] = None,
    ):
        self.memory_gb = memory_gb
        self.index = index
        self.geometry: Geometry = {p: n for p, n in (geometry or {}).items() if n > 0}
        self.used: Geometry = {p: n for p, n in (used or {}).items() if n > 0}
        for p, n in self.used.items():
            if n > self.geometry.get(p, 0):
                raise ValueError(f"used {n}x{p} exceeds geometry on gpu {index}")
        if self.allocated_gb(self.geometry) > memory_gb:
            raise ValueError(f"geometry exceeds {memory_gb}GB budget")

    @staticmethod
    def allocated_gb(geometry: Mapping[MpsProfile, int]) -> int:
        return sum(p.memory_gb * n for p, n in geometry.items())

    @property
    def free_gb(self) -> int:
        return self.memory_gb - self.allocated_gb(self.geometry)

    @property
    def free(self) -> Geometry:
        return {
            p: n - self.used.get(p, 0)
            for p, n in self.geometry.items()
            if n - self.used.get(p, 0) > 0
        }

    def has_free_capacity(self) -> bool:
        return self.free_gb >= MIN_SLICE_GB or bool(self.free)

    def free_capacity_gb(self) -> float:
        """Memory not held by running work: unallocated budget + free carved
        slices (best-fit node-ordering key)."""
        return float(self.free_gb) + sum(
            p.memory_gb * n for p, n in self.free.items()
        )

    def clone(self) -> "MpsGpu":
        return MpsGpu(self.memory_gb, self.index, dict(self.geometry), dict(self.used))

    def can_apply_geometry(self, new: Mapping[MpsProfile, int]) -> bool:
        new = {p: n for p, n in new.items() if n > 0}
        for p, n in self.used.items():
            if new.get(p, 0) < n:
                return False
        return self.allocated_gb(new) <= self.memory_gb

    def apply_geometry(self, new: Mapping[MpsProfile, int]) -> None:
        if not self.can_apply_geometry(new):
            raise ValueError(f"cannot apply {new} on gpu {self.index}")
        self.geometry = {p: n for p, n in new.items() if n > 0}

    def update_geometry_for(self, required: Mapping[MpsProfile, int]) -> bool:
        """Freeform carve: create requested slices while memory remains,
        sacrificing free slices when needed (slicing/gpu.go:162-247)."""
        required = {p: n for p, n in required.items() if n > 0}
        if not required:
            return False
        base: Geometry = dict(self.used)
        budget = self.memory_gb - self.allocated_gb(base)
        satisfied = False
        for profile in sorted(required, key=lambda p: -p.memory_gb):
            for _ in range(required[profile]):
                if profile.memory_gb <= budget:
                    base[profile] = base.get(profile, 0) + 1
                    budget -= profile.memory_gb
                    satisfied = True
        if not satisfied:
            return False
        for profile, n in sorted(self.free.items(), key=lambda kv: -kv[0].memory_gb):
            for _ in range(n):
                if profile.memory_gb <= budget:
                    base[profile] = base.get(profile, 0) + 1
                    budget -= profile.memory_gb
        if base == self.geometry:
            return False
        self.geometry = base
        return True

    def mark_used(self, profile: MpsProfile, count: int = 1) -> None:
        free = self.geometry.get(profile, 0) - self.used.get(profile, 0)
        if count > free:
            raise ValueError(f"cannot use {count}x{profile} on gpu {self.index}")
        self.used[profile] = self.used.get(profile, 0) + count

    def as_resources(self) -> Dict[str, int]:
        return {p.resource: n for p, n in self.geometry.items()}
