"""Port of `nos_tpu/tpu/mesh.py` (:1-243): `TpuMesh` (:27). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package.

TpuMesh: one node's partitionable chip mesh.

The analog of the reference's mig.GPU (pkg/gpu/mig/gpu.go:97-195): tracks the
current geometry (carved sub-slices) and which slices are in use, enforces the
never-delete-used invariant (gpu.go:103-107), and implements the greedy
UpdateGeometryFor search (gpu.go:141-195) under the ICI packability constraint.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

from nos_tpu_torch.tpu.packing import pack, pack_into, packable
from nos_tpu_torch.tpu.profile import Profile
from nos_tpu_torch.tpu.shape import Shape
from nos_tpu_torch.tpu.topology import Topology

Geometry = Dict[Profile, int]
# Physical footprint of a pinned (in-use) slice: (origin, oriented dims).
Pin = Tuple[Tuple[int, ...], Tuple[int, ...]]


def _clean(g: Mapping[Profile, int]) -> Geometry:
    return {p: int(n) for p, n in g.items() if n > 0}


class TpuMesh:
    def __init__(
        self,
        topology: Topology,
        geometry: Optional[Mapping[Profile, int]] = None,
        used: Optional[Mapping[Profile, int]] = None,
        pinned: Optional[List[Pin]] = None,
    ):
        """`pinned` (optional) is the physical footprint of the in-use slices
        as reported by the node agent's layout annotation. When present, every
        feasibility check packs *around* those immovable blocks with the same
        guillotine packer the agent applies plans with — so planner feasibility
        equals actuation feasibility. When absent (GPU modes, plain tests) the
        counts-only model is used, matching the reference where NVML owns MIG
        placement (SURVEY.md §7 hard parts: placement, not just counts)."""
        self.topology = topology
        self.geometry: Geometry = _clean(geometry or {})
        self.used: Geometry = _clean(used or {})
        self.pinned: Optional[List[Pin]] = list(pinned) if pinned is not None else None
        for p, n in self.used.items():
            if n > self.geometry.get(p, 0):
                raise ValueError(
                    f"used {n}x{p} exceeds geometry {self.geometry.get(p, 0)}x{p}"
                )
        if self.pinned is not None:
            # Agent-reported state is physically real; only sanity-check the
            # chip budget (the heuristic packer may not reproduce an exotic
            # but valid layout, and that must not crash the snapshot).
            carved = sum(p.chips * n for p, n in self.geometry.items())
            if carved > topology.chips:
                raise ValueError(
                    f"geometry {self._fmt(self.geometry)} exceeds {topology}"
                )
        elif not self._feasible(self.geometry):
            raise ValueError(
                f"geometry {self._fmt(self.geometry)} does not pack onto {topology}"
            )

    @staticmethod
    def _fmt(g: Mapping[Profile, int]) -> str:
        return "{" + ", ".join(f"{p}:{n}" for p, n in sorted(g.items())) + "}"

    # -- accounting --------------------------------------------------------
    @property
    def free(self) -> Geometry:
        return _clean(
            {p: n - self.used.get(p, 0) for p, n in self.geometry.items()}
        )

    @property
    def free_chips(self) -> int:
        return self.topology.chips - sum(p.chips * n for p, n in self.geometry.items())

    def has_free_capacity(self) -> bool:
        return self.free_chips > 0 or bool(self.free)

    def clone(self) -> "TpuMesh":
        return TpuMesh(
            self.topology, dict(self.geometry), dict(self.used), self.pinned
        )

    # -- feasibility --------------------------------------------------------
    def _feasible(
        self, geometry: Mapping[Profile, int], extra_unit_chips: int = 0
    ) -> bool:
        """Can `geometry` be realized on this mesh? With pinned placements,
        the in-use slices are immovable and only the remainder (free slices —
        the agent may delete and recreate those — plus any additions) must
        pack around them. `extra_unit_chips` adds single-chip placeholders for
        uncarved chips held by whole-chip pods."""
        geometry = _clean(geometry)
        unit = Profile(Shape((1,) * self.topology.shape.rank))
        if self.pinned is None:
            trial = dict(geometry)
            if extra_unit_chips > 0:
                trial[unit] = trial.get(unit, 0) + extra_unit_chips
            return packable(self.topology.shape, trial)
        movable: Geometry = {}
        for p, n in geometry.items():
            extra = n - self.used.get(p, 0)
            if extra < 0:
                return False  # geometry drops an in-use slice
            if extra > 0:
                movable[p] = extra
        if extra_unit_chips > 0:
            movable[unit] = movable.get(unit, 0) + extra_unit_chips
        return pack_into(self.topology.shape, list(self.pinned), movable) is not None

    # -- geometry transitions ---------------------------------------------
    def can_apply_geometry(self, new: Mapping[Profile, int]) -> bool:
        """A new geometry is applicable iff it keeps every in-use slice
        (never-delete-used, mig/gpu.go:103-107), uses only allowed profiles,
        and packs onto the ICI mesh."""
        new = _clean(new)
        for p, n in self.used.items():
            if new.get(p, 0) < n:
                return False
        if any(not self.topology.is_profile_allowed(p) for p in new):
            return False
        return self._feasible(new)

    def apply_geometry(self, new: Mapping[Profile, int]) -> None:
        if not self.can_apply_geometry(new):
            raise ValueError(
                f"cannot apply geometry {self._fmt(new)} on {self.topology} "
                f"(used={self._fmt(self.used)})"
            )
        self.geometry = _clean(new)

    def update_geometry_for(
        self, required: Mapping[Profile, int], reserved_chips: int = 0
    ) -> bool:
        """Greedily re-carve free capacity to satisfy as much of `required` as
        possible, never touching used slices. Returns True iff the geometry
        changed. Mirrors mig/gpu.go UpdateGeometryFor:141-195 + the MPS
        delete-free-then-recreate heuristic (slicing/gpu.go:162-232), with
        packability standing in for the allowed-geometry table lookup.

        `reserved_chips` protects uncarved chips held by whole-chip
        (google.com/tpu) pods: they participate in packability as single-chip
        placeholders so carving never steals them.
        """
        required = {
            p: n for p, n in required.items() if n > 0 and self.topology.is_profile_allowed(p)
        }
        if not required:
            return False

        # Start from the immutable floor: slices currently in use.
        base: Geometry = dict(self.used)
        satisfied_any = False
        # Add required profiles largest-first so big contiguous blocks are
        # reserved before fragmentation. Feasibility packs around the pinned
        # in-use placements when the agent reported them.
        for profile in sorted(required, key=lambda p: (-p.chips, p.name)):
            for _ in range(required[profile]):
                trial = dict(base)
                trial[profile] = trial.get(profile, 0) + 1
                if self._feasible(trial, extra_unit_chips=reserved_chips):
                    base = trial
                    satisfied_any = True

        if not satisfied_any:
            return False

        # Preserve existing free slices where they still fit (avoid churn).
        for profile, n in sorted(self.free.items(), key=lambda kv: (-kv[0].chips, kv[0].name)):
            for _ in range(n):
                trial = dict(base)
                trial[profile] = trial.get(profile, 0) + 1
                if self._feasible(trial, extra_unit_chips=reserved_chips):
                    base = trial

        new_geometry = _clean(base)
        if new_geometry == self.geometry:
            return False
        self.geometry = new_geometry
        return True

    # -- usage -------------------------------------------------------------
    def mark_used(self, profile: Profile, count: int = 1) -> None:
        free = self.geometry.get(profile, 0) - self.used.get(profile, 0)
        if count > free:
            raise ValueError(f"cannot use {count}x{profile}: only {free} free")
        self.used[profile] = self.used.get(profile, 0) + count

    def mark_unused(self, profile: Profile, count: int = 1) -> None:
        if self.used.get(profile, 0) < count:
            raise ValueError(f"cannot release {count}x{profile}")
        self.used[profile] -= count
        if self.used[profile] == 0:
            del self.used[profile]

    def release(self, profile: Profile, count: int = 1) -> bool:
        """Release in-use slices of `profile` AND unpin their physical
        placements, so a what-if re-carve may move through the freed region
        (consolidation: the planner evicts the pods that held them).

        Pins carry no pod identity, so unpinning is only sound when `count`
        equals ALL in-use slices of the profile — then every dims-matching
        pin provably belongs to a released slice. A partial release is
        ambiguous (unpinning the wrong block would certify re-carves the
        agent must refuse); it is left fully pinned-and-used and reported as
        False so callers model the region conservatively."""
        held = self.used.get(profile, 0)
        if count > held:
            raise ValueError(f"cannot release {count}x{profile}: only {held} used")
        if self.pinned is not None and count < held:
            return False  # ambiguous pin ownership: keep used + pinned
        self.mark_unused(profile, count)
        if self.pinned is None:
            return True
        target = tuple(sorted(profile.shape.dims))
        removed = 0
        kept: List[Pin] = []
        for origin, dims in self.pinned:
            if removed < count and tuple(sorted(dims)) == target:
                removed += 1
                continue
            kept.append((origin, dims))
        self.pinned = kept
        return True

    # -- resource views ----------------------------------------------------
    def as_resources(self) -> Dict[str, int]:
        """Extended resources this geometry exposes (allocatable scalars,
        the analog of mig/node.go:172-195 recompute)."""
        return {p.resource: n for p, n in self.geometry.items()}

    def placements(self):
        return pack(self.topology.shape, self.geometry)

    def __repr__(self) -> str:
        return (
            f"TpuMesh({self.topology}, geometry={self._fmt(self.geometry)}, "
            f"used={self._fmt(self.used)})"
        )
