"""Port of `nos_tpu/gpu/mig.py:1` (:1-407): `MigProfile` (:26), `MigModelSpec`
(:62), `set_known_geometries` (:160), `clear_known_geometry_overrides`
(:168), `model_spec` (:172), `allowed_geometries` (:176), `model_known`
(:187), `geometry_allowed` (:211), `geometry_feasible` (:223), `MigGpu`
(:239). Copied verbatim; only the imports point at the port, which imports
nothing of the JAX package.

MIG device domain model.

Analog of pkg/gpu/mig/{profile.go:29-96, known_configs.go:25-142, gpu.go:97-195}.
A MIG profile `<G>g.<M>gb` consumes G of the GPU's compute slots and M GB of
its memory. The per-model allowed-geometry tables are the reference's exact
defaults (known_configs.go:25-142) — they are the published wire protocol, and
NVML placement rejects combinations a naive budget check would admit — with a
slots+memory *generator* as the fallback for models the tables don't cover.
Tables remain overridable per model via `set_known_geometries` (the
knownMigGeometries config analog).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Dict, List, Mapping, Optional, Tuple

from nos_tpu_torch import constants

Geometry = Dict["MigProfile", int]


@total_ordering
@dataclass(frozen=True)
class MigProfile:
    gi: int  # compute (GPU-instance) slots, the <G>g part
    memory_gb: int

    @classmethod
    def parse(cls, name: str) -> "MigProfile":
        """Parse '1g.10gb' or 'nvidia.com/mig-1g.10gb'."""
        if name.startswith(constants.RESOURCE_MIG_PREFIX):
            name = name[len(constants.RESOURCE_MIG_PREFIX):]
        m = constants.RESOURCE_MIG_REGEX.match(f"{constants.RESOURCE_MIG_PREFIX}{name}")
        if not m:
            raise ValueError(f"invalid MIG profile {name!r}")
        return cls(int(m.group(1)), int(m.group(2)))

    @classmethod
    def from_resource(cls, resource_name: str) -> Optional["MigProfile"]:
        m = constants.RESOURCE_MIG_REGEX.match(resource_name)
        return cls(int(m.group(1)), int(m.group(2))) if m else None

    @property
    def name(self) -> str:
        return f"{self.gi}g.{self.memory_gb}gb"

    @property
    def resource(self) -> str:
        return f"{constants.RESOURCE_MIG_PREFIX}{self.name}"

    def __lt__(self, other: "MigProfile") -> bool:
        # Smaller memory first (profile.go ordering :84-96).
        return (self.memory_gb, self.gi) < (other.memory_gb, other.gi)

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class MigModelSpec:
    """Per-GPU-model capability: profile menu + compute/memory budgets."""

    name: str
    total_gi: int
    memory_gb: int
    profiles: Tuple[str, ...]

    def menu(self) -> Tuple[MigProfile, ...]:
        return tuple(MigProfile.parse(p) for p in self.profiles)


# Public MIG capability matrix (NVIDIA docs; the known_configs.go analog).
KNOWN_MIG_MODELS: Dict[str, MigModelSpec] = {
    "NVIDIA-A30": MigModelSpec(
        "NVIDIA-A30", total_gi=4, memory_gb=24, profiles=("1g.6gb", "2g.12gb", "4g.24gb")
    ),
    "NVIDIA-A100-PCIE-40GB": MigModelSpec(
        "NVIDIA-A100-PCIE-40GB",
        total_gi=7,
        memory_gb=40,
        profiles=("1g.5gb", "2g.10gb", "3g.20gb", "4g.20gb", "7g.40gb"),
    ),
    "NVIDIA-A100-SXM4-80GB": MigModelSpec(
        "NVIDIA-A100-SXM4-80GB",
        total_gi=7,
        memory_gb=80,
        # NVML exposes the full-GPU 80GB profile as 7g.79gb (profile.go:46).
        profiles=("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.79gb"),
    ),
}
# 80GB PCIe variant shares the SXM capability set.
KNOWN_MIG_MODELS["NVIDIA-A100-PCIE-80GB"] = MigModelSpec(
    "NVIDIA-A100-PCIE-80GB",
    total_gi=7,
    memory_gb=80,
    profiles=KNOWN_MIG_MODELS["NVIDIA-A100-SXM4-80GB"].profiles,
)

def _G(**profiles: int) -> Geometry:
    return {MigProfile.parse(name.replace("_", ".")): n for name, n in profiles.items()}


# The reference's exact default geometry menus (known_configs.go:25-142),
# reproduced verbatim — including upstream's idiosyncratic 80GB rows (e.g.
# 2g.20gb x2 + 3g.20gb, and the 7g.79gb profile): driver scenarios judge
# behavioral identity on the same inputs.
DEFAULT_KNOWN_GEOMETRIES: Dict[str, Tuple[Geometry, ...]] = {
    "A30": (
        _G(**{"4g_24gb": 1}),
        _G(**{"2g_12gb": 2}),
        _G(**{"2g_12gb": 1, "1g_6gb": 2}),
        _G(**{"1g_6gb": 4}),
    ),
    "NVIDIA-A100-40GB-SXM4": (
        _G(**{"7g_40gb": 1}),
        _G(**{"4g_20gb": 1, "2g_10gb": 1, "1g_5gb": 1}),
        _G(**{"4g_20gb": 1, "1g_5gb": 3}),
        _G(**{"3g_20gb": 2}),
        _G(**{"3g_20gb": 1, "2g_10gb": 1, "1g_5gb": 1}),
        _G(**{"3g_20gb": 1, "1g_5gb": 3}),
        _G(**{"2g_10gb": 2, "3g_20gb": 1}),
        _G(**{"2g_10gb": 1, "1g_5gb": 2, "3g_20gb": 1}),
        _G(**{"2g_10gb": 3, "1g_5gb": 1}),
        _G(**{"2g_10gb": 2, "1g_5gb": 3}),
        _G(**{"2g_10gb": 1, "1g_5gb": 5}),
        _G(**{"1g_5gb": 7}),
    ),
    "NVIDIA-A100-80GB-PCIe": (
        _G(**{"7g_79gb": 1}),
        _G(**{"4g_40gb": 1, "2g_20gb": 1, "1g_10gb": 1}),
        _G(**{"4g_40gb": 1, "1g_10gb": 3}),
        _G(**{"3g_40gb": 2}),
        _G(**{"3g_40gb": 1, "2g_20gb": 1, "1g_10gb": 1}),
        _G(**{"3g_40gb": 1, "1g_10gb": 3}),
        _G(**{"2g_20gb": 2, "3g_20gb": 1}),
        _G(**{"2g_10gb": 1, "1g_10gb": 2, "3g_40gb": 1}),
        _G(**{"2g_20gb": 3, "1g_10gb": 1}),
        _G(**{"2g_20gb": 2, "1g_10gb": 3}),
        _G(**{"2g_20gb": 1, "1g_10gb": 5}),
        _G(**{"1g_10gb": 7}),
    ),
}

# GFD product-label spellings -> canonical table key. The reference matches
# models by its own constants (model.go:26-28); real clusters see several
# `nvidia.com/gpu.product` spellings for the same silicon.
MODEL_ALIASES: Dict[str, str] = {
    "NVIDIA-A30": "A30",
    "NVIDIA-A100-PCIE-40GB": "NVIDIA-A100-40GB-SXM4",
    "NVIDIA-A100-SXM4-40GB": "NVIDIA-A100-40GB-SXM4",
    "NVIDIA-A100-SXM4-80GB": "NVIDIA-A100-80GB-PCIe",
    "NVIDIA-A100-PCIE-80GB": "NVIDIA-A100-80GB-PCIe",
}

_overrides: Dict[str, List[Geometry]] = {}


def set_known_geometries(model: str, geometries: List[Mapping[str, int]]) -> None:
    """Override the allowed geometries for a model from config
    (mig/known_configs.go SetKnownGeometries:144-162 analog)."""
    _overrides[model] = [
        {MigProfile.parse(p): n for p, n in g.items()} for g in geometries
    ]


def clear_known_geometry_overrides() -> None:
    _overrides.clear()


def model_spec(model: str) -> Optional[MigModelSpec]:
    return KNOWN_MIG_MODELS.get(model)


def allowed_geometries(model: str) -> Optional[List[Geometry]]:
    """The model's geometry menu: config override > exact default table >
    None (caller falls back to the slots+memory generator)."""
    canon = MODEL_ALIASES.get(model, model)
    for key in (model, canon):
        if key in _overrides:
            return list(_overrides[key])
    table = DEFAULT_KNOWN_GEOMETRIES.get(canon)
    return list(table) if table is not None else None


def model_known(model: str) -> bool:
    canon = MODEL_ALIASES.get(model, model)
    return (
        model in _overrides
        or canon in _overrides
        or canon in DEFAULT_KNOWN_GEOMETRIES
        or model in KNOWN_MIG_MODELS
    )


def _budget_allowed(model: str, geometry: Mapping[MigProfile, int]) -> bool:
    """Generator fallback for models without a table: menu membership +
    compute-slot and memory budgets."""
    spec = KNOWN_MIG_MODELS.get(model)
    if spec is None:
        return False
    menu = set(spec.menu())
    if any(p not in menu for p in geometry):
        return False
    total_gi = sum(p.gi * n for p, n in geometry.items())
    total_mem = sum(p.memory_gb * n for p, n in geometry.items())
    return total_gi <= spec.total_gi and total_mem <= spec.memory_gb


def geometry_allowed(model: str, geometry: Mapping[MigProfile, int]) -> bool:
    """Reference AllowsGeometry (gpu.go:197-205): EXACT membership in the
    model's menu (empty geometry = unpartitioned, always fine)."""
    geometry = {p: n for p, n in geometry.items() if n > 0}
    if not geometry:
        return True
    table = allowed_geometries(model)
    if table is not None:
        return any(geometry == g for g in table)
    return _budget_allowed(model, geometry)


def geometry_feasible(model: str, geometry: Mapping[MigProfile, int]) -> bool:
    """True iff `geometry` could exist on the device: a SUB-multiset of some
    allowed geometry. Statuses read back from a node can be partial (the
    agent applies plans partially when NVML ordering blocks full creation),
    so validity-on-read is weaker than apply-time membership."""
    geometry = {p: n for p, n in geometry.items() if n > 0}
    if not geometry:
        return True
    table = allowed_geometries(model)
    if table is not None:
        return any(
            all(g.get(p, 0) >= n for p, n in geometry.items()) for g in table
        )
    return _budget_allowed(model, geometry)


class MigGpu:
    """One MIG-capable GPU (mig/gpu.go:97-195 analog)."""

    def __init__(
        self,
        model: str,
        index: int,
        geometry: Optional[Mapping[MigProfile, int]] = None,
        used: Optional[Mapping[MigProfile, int]] = None,
    ):
        self.model = model
        self.index = index
        self.geometry: Geometry = {p: n for p, n in (geometry or {}).items() if n > 0}
        self.used: Geometry = {p: n for p, n in (used or {}).items() if n > 0}
        for p, n in self.used.items():
            if n > self.geometry.get(p, 0):
                raise ValueError(f"used {n}x{p} exceeds geometry on gpu {index}")
        # Feasibility, not menu membership: the status read off a node can be
        # a partially applied geometry.
        if not geometry_feasible(model, self.geometry):
            raise ValueError(f"geometry not possible on {model}: {self.geometry}")

    @property
    def free(self) -> Geometry:
        return {
            p: n - self.used.get(p, 0)
            for p, n in self.geometry.items()
            if n - self.used.get(p, 0) > 0
        }

    def free_capacity_gb(self) -> float:
        """Memory not held by running work: uncarved budget + free carved
        slices (best-fit node-ordering key). The budget comes from the model
        spec when known, else from the richest allowed-geometry row — alias
        spellings and set_known_geometries-only models must not report an
        empty GPU as zero free capacity (that inverts best-fit into carving
        up empty devices first)."""
        spec = model_spec(self.model)
        carved = sum(p.memory_gb * n for p, n in self.geometry.items())
        if spec is not None:
            total = float(spec.memory_gb)
        else:
            table = allowed_geometries(self.model)
            if table:
                total = float(
                    max(sum(p.memory_gb * n for p, n in row.items()) for row in table)
                )
            else:
                total = float(carved)
        uncarved = max(0.0, total - carved)
        return uncarved + sum(p.memory_gb * n for p, n in self.free.items())

    def has_free_capacity(self) -> bool:
        if bool(self.free):
            return True
        table = allowed_geometries(self.model)
        if table is not None:
            # Free capacity = some menu geometry strictly extends what is
            # carved now without deleting anything in use.
            return any(
                all(g.get(p, 0) >= n for p, n in self.used.items())
                and sum(g.values()) > sum(self.geometry.values())
                for g in table
            )
        spec = KNOWN_MIG_MODELS.get(self.model)
        if spec is None:
            return False
        used_gi = sum(p.gi * n for p, n in self.geometry.items())
        return used_gi < spec.total_gi

    def clone(self) -> "MigGpu":
        return MigGpu(self.model, self.index, dict(self.geometry), dict(self.used))

    def can_apply_geometry(self, new: Mapping[MigProfile, int]) -> bool:
        new = {p: n for p, n in new.items() if n > 0}
        for p, n in self.used.items():
            if new.get(p, 0) < n:
                return False  # never delete used (gpu.go:103-107)
        return geometry_allowed(self.model, new)

    def apply_geometry(self, new: Mapping[MigProfile, int]) -> None:
        if not self.can_apply_geometry(new):
            raise ValueError(f"cannot apply {new} on gpu {self.index} ({self.model})")
        self.geometry = {p: n for p, n in new.items() if n > 0}

    def update_geometry_for(self, required: Mapping[MigProfile, int]) -> bool:
        """Re-carve toward `required` without deleting used slices
        (gpu.go UpdateGeometryFor:141-195). With a geometry menu, pick the
        allowed geometry providing the most missing required profiles and
        apply it whole (the reference's algorithm); the budget-generator
        fallback carves greedily."""
        required = {p: n for p, n in required.items() if n > 0}
        if not required:
            return False
        table = allowed_geometries(self.model)
        if table is not None:
            return self._update_geometry_from_menu(required, table)
        spec = KNOWN_MIG_MODELS.get(self.model)
        required = {
            p: n
            for p, n in required.items()
            if spec is None or p in set(spec.menu())
        }
        if not required:
            return False
        base: Geometry = dict(self.used)
        satisfied = False
        for profile in sorted(required, key=lambda p: (-p.memory_gb, -p.gi)):
            for _ in range(required[profile]):
                trial = dict(base)
                trial[profile] = trial.get(profile, 0) + 1
                if geometry_allowed(self.model, trial):
                    base = trial
                    satisfied = True
        if not satisfied:
            return False
        for profile, n in sorted(self.free.items(), key=lambda kv: (-kv[0].memory_gb,)):
            for _ in range(n):
                trial = dict(base)
                trial[profile] = trial.get(profile, 0) + 1
                if geometry_allowed(self.model, trial):
                    base = trial
        if base == self.geometry:
            return False
        self.geometry = base
        return True

    def _update_geometry_from_menu(
        self, required: Mapping[MigProfile, int], table: List[Geometry]
    ) -> bool:
        """The reference's candidate scan (gpu.go:141-193): for each menu
        geometry, count how many MISSING required profiles it would provide
        beyond current free devices (capped per profile at the requirement),
        skip candidates that would delete used devices, take the best."""
        best: Optional[Geometry] = None
        best_key: Optional[tuple] = None
        for candidate in table:
            if not self.can_apply_geometry(candidate):
                continue
            # Applying replaces the whole geometry, so score what the
            # candidate provides POST-apply (current free devices only
            # survive if the candidate re-includes them); tie-break toward
            # preserving the current carve to minimize device churn.
            provided = sum(
                min(max(candidate.get(p, 0) - self.used.get(p, 0), 0), n)
                for p, n in required.items()
            )
            preserved = sum(
                min(candidate.get(p, 0), g) for p, g in self.geometry.items()
            )
            key = (provided, preserved)
            if provided > 0 and (best_key is None or key > best_key):
                best, best_key = candidate, key
        if best is None:
            return False
        new_geometry = {p: n for p, n in best.items() if n > 0}
        if new_geometry == self.geometry:
            return False  # the best menu row is the current carve: no-op
        self.geometry = new_geometry
        return True

    def mark_used(self, profile: MigProfile, count: int = 1) -> None:
        free = self.geometry.get(profile, 0) - self.used.get(profile, 0)
        if count > free:
            raise ValueError(f"cannot use {count}x{profile} on gpu {self.index}")
        self.used[profile] = self.used.get(profile, 0) + count

    def as_resources(self) -> Dict[str, int]:
        return {p.resource: n for p, n in self.geometry.items()}
