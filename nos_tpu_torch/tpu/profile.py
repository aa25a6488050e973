"""Port of `nos_tpu/tpu/profile.py` (:1-76): `Profile` (:20),
`chips_of_resources` (:62). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

TPU sub-slice profiles.

The analog of MIG profile names (reference pkg/gpu/mig/profile.go:29-96): a
profile identifies one ICI-contiguous sub-slice shape, exposed to pods as the
extended resource ``google.com/tpu-<shape>`` (e.g. ``google.com/tpu-2x2``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Optional

from nos_tpu_torch import constants
from nos_tpu_torch.tpu.shape import Shape


@total_ordering
@dataclass(frozen=True)
class Profile:
    shape: Shape

    @classmethod
    def parse(cls, name: str) -> "Profile":
        """Parse '2x2' or a full resource name 'google.com/tpu-2x2'."""
        if name.startswith(constants.RESOURCE_TPU_SLICE_PREFIX):
            name = name[len(constants.RESOURCE_TPU_SLICE_PREFIX):]
        return cls(Shape.parse(name))

    @classmethod
    def from_resource(cls, resource_name: str) -> Optional["Profile"]:
        m = constants.RESOURCE_TPU_SLICE_REGEX.match(resource_name)
        return cls(Shape.parse(m.group(1))) if m else None

    @property
    def name(self) -> str:
        return self.shape.name

    @property
    def resource(self) -> str:
        return f"{constants.RESOURCE_TPU_SLICE_PREFIX}{self.name}"

    @property
    def chips(self) -> int:
        return self.shape.chips

    def memory_gb(self, generation: str) -> int:
        per_chip = constants.TPU_CHIP_MEMORY_GB.get(
            generation, constants.DEFAULT_TPU_CHIP_MEMORY_GB
        )
        return per_chip * self.chips

    def __lt__(self, other: "Profile") -> bool:
        # Order: fewer chips first, ties by name — mirrors MIG profile ordering
        # (profile.go:84-96) used by the pod sorter ("smaller profiles first").
        return (self.chips, self.name) < (other.chips, other.name)

    def __str__(self) -> str:
        return self.name


def chips_of_resources(resources) -> float:
    """TPU chips represented by a resource mapping: whole chips plus every
    sub-slice profile's chip footprint. The single accounting rule shared by
    the scheduler's reservation math and the simulation's utilization
    integration — a profile request and the whole-chip capacity it carves
    into are the same chips."""
    chips = 0.0
    for res, qty in resources.items():
        if res == constants.RESOURCE_TPU:
            chips += qty
        else:
            profile = Profile.from_resource(res)
            if profile is not None:
                chips += profile.chips * qty
    return chips
