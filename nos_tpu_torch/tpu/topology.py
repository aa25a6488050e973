"""Port of `nos_tpu/tpu/topology.py` (:1-107): `accelerator_generation` (:44),
`Topology` (:50). Copied verbatim; only the imports point at the port, which
imports nothing of the JAX package.

TPU topologies and the known-geometry menu.

The analog of the reference's hardcoded MIG geometry tables
(pkg/gpu/mig/known_configs.go:25-142): for each TPU generation we declare the
valid sub-slice shapes, and a topology derives its *allowed profile menu* as
every known shape that tiles its mesh with aligned origins. Unlike MIG —
where NVML owns placement — ICI contiguity is a graph constraint, so validity
of a full geometry is checked by the canonical packer (nos_tpu_torch.tpu.packing),
not by a static table of complete geometries.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Dict, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.tpu.profile import Profile
from nos_tpu_torch.tpu.shape import Shape

# GKE accelerator-type label value -> generation
# (cloud.google.com/gke-tpu-accelerator values).
_ACCELERATOR_GENERATIONS: Dict[str, str] = {
    "tpu-v4-podslice": "v4",
    "tpu-v5-lite-podslice": "v5e",
    "tpu-v5-lite-device": "v5e",
    "tpu-v5p-slice": "v5p",
    "tpu-v6e-slice": "v6e",
}

# Valid sub-slice shapes per generation (canonical orientation, dims ascending).
# 2D generations (v5e/v6e) use x-by-y chip meshes; 3D generations (v4/v5p) use
# cuboids. These mirror the publicly documented slice shapes; 1x1 / 1x1x1 are
# single-chip slices (the fractional unit).
KNOWN_SLICE_SHAPES: Dict[str, Tuple[str, ...]] = {
    "v5e": ("1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16"),
    "v6e": ("1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16"),
    "v4": ("1x1x1", "1x2x2", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8", "4x8x8", "8x8x8"),
    "v5p": ("1x1x1", "1x2x2", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8", "4x8x8", "8x8x8"),
}


def accelerator_generation(accelerator_label: str) -> Optional[str]:
    """Map a gke-tpu-accelerator label value to a generation ('v5e', ...)."""
    return _ACCELERATOR_GENERATIONS.get(accelerator_label)


@dataclass(frozen=True)
class Topology:
    """One node's chip mesh: generation + shape (e.g. v5e 4x4 = 16 chips)."""

    generation: str
    shape: Shape

    @classmethod
    def parse(cls, generation: str, topology: str) -> "Topology":
        return cls(generation, Shape.parse(topology))

    @classmethod
    def from_node_labels(cls, labels: Dict[str, str]) -> Optional["Topology"]:
        """Build from GKE discovery labels (the GFD-label analog,
        reference pkg/gpu/util.go:30-73)."""
        acc = labels.get(constants.LABEL_TPU_ACCELERATOR, "")
        topo = labels.get(constants.LABEL_TPU_TOPOLOGY, "")
        gen = accelerator_generation(acc)
        if gen is None or not topo:
            return None
        return cls(gen, Shape.parse(topo))

    @property
    def chips(self) -> int:
        return self.shape.chips

    @cached_property
    def allowed_profiles(self) -> Tuple[Profile, ...]:
        """Profiles from the generation's menu that tile this mesh (some
        orientation divides it elementwise), smallest first."""
        return _allowed_profiles(self.generation, self.shape)

    def is_profile_allowed(self, profile: Profile) -> bool:
        return profile in self.allowed_profiles

    @property
    def chip_memory_gb(self) -> int:
        return constants.TPU_CHIP_MEMORY_GB.get(
            self.generation, constants.DEFAULT_TPU_CHIP_MEMORY_GB
        )

    def __str__(self) -> str:
        return f"{self.generation}-{self.shape.name}"


@lru_cache(maxsize=None)
def _allowed_profiles(generation: str, mesh: Shape) -> Tuple[Profile, ...]:
    out = []
    for name in KNOWN_SLICE_SHAPES.get(generation, ()):
        shape = Shape.parse(name)
        if shape.chips > mesh.chips:
            continue
        # The identity profile (the whole mesh as one sub-slice) is allowed:
        # a workload asking for a connected NxM mesh must be placeable on a
        # node whose mesh is exactly NxM, not only on larger nodes. Uncarved
        # chips remain the plain google.com/tpu resource.
        if any(o.divides(mesh) for o in shape.orientations()):
            out.append(Profile(shape))
    return tuple(sorted(out))
