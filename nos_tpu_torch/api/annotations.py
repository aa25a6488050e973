"""Port of `nos_tpu/api/annotations.py` (:1-279): `SpecAnnotation` (:26),
`StatusAnnotation` (:37), `parse_spec` (:51), `parse_status` (:61),
`format_spec` (:71), `format_status` (:75), `spec_from_geometry` (:79),
`status_from_geometry` (:88), .... Copied verbatim; only the imports point
at the port, which imports nothing of the JAX package.

The spec/status node-annotation protocol.

This is the RPC protocol between the central partitioner and node agents
(reference pkg/api/nos.nebuly.com/v1alpha1/annotations.go:21-58 and the
parser/formatter in pkg/gpu/annotation.go:29-224):

  spec   (written by planner):  tpu.nos/spec-dev-<index>-<profile> = <qty>
  status (written by agent):    tpu.nos/status-dev-<index>-<profile>-<free|used> = <qty>
  plan handshake:               tpu.nos/spec-partitioning-plan / status-partitioning-plan

`index` identifies a partitionable device on the node (a GPU index, or 0 for
the node's whole TPU mesh); `profile` is mode-specific ("2x2", "1g.10gb",
"10gb"). The planner won't re-plan until every node's status plan id matches
its spec plan id (reference partitioner_controller.go:212-232).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from nos_tpu_torch import constants


@dataclass(frozen=True)
class SpecAnnotation:
    device_index: int
    profile: str
    quantity: int

    @property
    def key(self) -> str:
        return f"{constants.ANNOTATION_SPEC_PREFIX}{self.device_index}-{self.profile}"


@dataclass(frozen=True)
class StatusAnnotation:
    device_index: int
    profile: str
    status: str  # "free" | "used"
    quantity: int

    @property
    def key(self) -> str:
        return (
            f"{constants.ANNOTATION_STATUS_PREFIX}{self.device_index}-"
            f"{self.profile}-{self.status}"
        )


def parse_spec(annotations: Mapping[str, str]) -> List[SpecAnnotation]:
    out = []
    for k, v in annotations.items():
        m = constants.ANNOTATION_SPEC_REGEX.match(k)
        if m:
            out.append(SpecAnnotation(int(m.group(1)), m.group(2), int(v)))
    out.sort(key=lambda a: (a.device_index, a.profile))
    return out


def parse_status(annotations: Mapping[str, str]) -> List[StatusAnnotation]:
    out = []
    for k, v in annotations.items():
        m = constants.ANNOTATION_STATUS_REGEX.match(k)
        if m:
            out.append(StatusAnnotation(int(m.group(1)), m.group(2), m.group(3), int(v)))
    out.sort(key=lambda a: (a.device_index, a.profile, a.status))
    return out


def format_spec(specs: Iterable[SpecAnnotation]) -> Dict[str, str]:
    return {s.key: str(s.quantity) for s in specs if s.quantity > 0}


def format_status(statuses: Iterable[StatusAnnotation]) -> Dict[str, str]:
    return {s.key: str(s.quantity) for s in statuses}


def spec_from_geometry(device_index: int, geometry: Mapping) -> List[SpecAnnotation]:
    """Geometry (profile -> count; profile str()s to its name) -> spec annotations."""
    return [
        SpecAnnotation(device_index, str(p), int(n))
        for p, n in sorted(geometry.items(), key=lambda kv: str(kv[0]))
        if n > 0
    ]


def status_from_geometry(
    device_index: int, geometry: Mapping, used: Mapping
) -> List[StatusAnnotation]:
    out = []
    for p, n in sorted(geometry.items(), key=lambda kv: str(kv[0])):
        u = min(int(used.get(p, 0)), int(n))
        out.append(StatusAnnotation(device_index, str(p), "used", u))
        out.append(StatusAnnotation(device_index, str(p), "free", int(n) - u))
    return out


def geometry_counts_from_spec(
    specs: Iterable[SpecAnnotation],
) -> Dict[int, Dict[str, int]]:
    """device_index -> {profile name -> quantity}."""
    out: Dict[int, Dict[str, int]] = {}
    for s in specs:
        out.setdefault(s.device_index, {})[s.profile] = s.quantity
    return out


def geometry_counts_from_status(
    statuses: Iterable[StatusAnnotation],
) -> Dict[int, Dict[str, Tuple[int, int]]]:
    """device_index -> {profile name -> (free, used)}."""
    out: Dict[int, Dict[str, Tuple[int, int]]] = {}
    for s in statuses:
        free, used = out.setdefault(s.device_index, {}).get(s.profile, (0, 0))
        if s.status == "free":
            free = s.quantity
        else:
            used = s.quantity
        out[s.device_index][s.profile] = (free, used)
    return out


def spec_matches_status(
    specs: Iterable[SpecAnnotation], statuses: Iterable[StatusAnnotation]
) -> bool:
    """True when the reported geometry equals the desired one (per device &
    profile: spec quantity == free+used) — mig/annotation.go SpecMatchesStatus."""
    want = geometry_counts_from_spec(specs)
    got = {
        idx: {prof: free + used for prof, (free, used) in profs.items() if free + used > 0}
        for idx, profs in geometry_counts_from_status(statuses).items()
    }
    got = {idx: profs for idx, profs in got.items() if profs}
    want = {
        idx: {prof: q for prof, q in profs.items() if q > 0}
        for idx, profs in want.items()
    }
    want = {idx: profs for idx, profs in want.items() if profs}
    return want == got


# -- plan-id handshake ------------------------------------------------------
def get_spec_plan(annotations: Mapping[str, str]) -> Optional[str]:
    return annotations.get(constants.ANNOTATION_SPEC_PLAN)


def get_status_plan(annotations: Mapping[str, str]) -> Optional[str]:
    return annotations.get(constants.ANNOTATION_STATUS_PLAN)


def node_reported_last_plan(annotations: Mapping[str, str]) -> bool:
    spec = get_spec_plan(annotations)
    return spec is None or spec == get_status_plan(annotations)


def strip_spec_annotations(
    annotations: Dict[str, str], profile_filter=None
) -> None:
    """Remove spec partitioning annotations in place (planner rewrite).
    With `profile_filter` (profile-name -> bool), only matching profiles'
    annotations are removed — on a hybrid node the MIG and MPS partitioners
    each rewrite their own mode's specs and must leave the other's plan
    standing (constants.KIND_HYBRID)."""
    for k in list(annotations):
        m = constants.ANNOTATION_SPEC_REGEX.match(k)
        if not m:
            continue
        if profile_filter is not None and not profile_filter(m.group(2)):
            continue
        del annotations[k]


def strip_status_annotations(annotations: Dict[str, str]) -> None:
    for k in [k for k in annotations if constants.ANNOTATION_STATUS_REGEX.match(k)]:
        del annotations[k]
    annotations.pop(constants.ANNOTATION_STATUS_LAYOUT, None)


# -- physical slice layout ---------------------------------------------------
# TPU sub-slices are position-constrained (ICI contiguity): the planner cannot
# judge whether a new slice fits without knowing where the in-use ones sit.
# The agent therefore reports the full layout — "<profile>@<origin>/<dims>:u|f"
# entries joined by ";", e.g. "2x4@0,0/2,4:u;1x1@6,6/1,1:f". `dims` is the
# oriented footprint actually placed (may be a rotation of the profile shape).


@dataclass(frozen=True)
class SliceLayoutEntry:
    profile: str
    origin: Tuple[int, ...]
    dims: Tuple[int, ...]
    used: bool


def format_layout(entries: Iterable[SliceLayoutEntry]) -> str:
    parts = []
    for e in sorted(entries, key=lambda e: (e.origin, e.profile)):
        origin = ",".join(str(c) for c in e.origin)
        dims = ",".join(str(c) for c in e.dims)
        parts.append(f"{e.profile}@{origin}/{dims}:{'u' if e.used else 'f'}")
    return ";".join(parts)


def parse_layout(value: Optional[str]) -> List[SliceLayoutEntry]:
    if not value:
        return []
    out = []
    for part in value.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, flag = part.rpartition(":")
        profile, _, pos = head.partition("@")
        origin_s, _, dims_s = pos.partition("/")
        out.append(
            SliceLayoutEntry(
                profile=profile,
                origin=tuple(int(c) for c in origin_s.split(",")),
                dims=tuple(int(c) for c in dims_s.split(",")),
                used=flag == "u",
            )
        )
    return out


def get_layout(annotations: Mapping[str, str]) -> List[SliceLayoutEntry]:
    return parse_layout(annotations.get(constants.ANNOTATION_STATUS_LAYOUT))


# -- migration holds (move protocol) ------------------------------------------
def profile_of_resource(resource_name: str) -> Optional[str]:
    """Extract the mode-agnostic profile name from a slice resource name
    ("google.com/tpu-4x4" -> "4x4", "nvidia.com/mig-1g.5gb" -> "1g.5gb",
    "nvidia.com/gpu-10gb" -> "10gb"); None for non-slice resources."""
    m = constants.RESOURCE_TPU_SLICE_REGEX.match(resource_name)
    if m:
        return m.group(1)
    m = constants.RESOURCE_MIG_REGEX.match(resource_name)
    if m:
        return resource_name[len(constants.RESOURCE_MIG_PREFIX):]
    m = constants.RESOURCE_MPS_REGEX.match(resource_name)
    if m:
        return f"{m.group(1)}gb"
    return None


def format_migration_hold(holds: Mapping[str, int]) -> str:
    """"<profile>:<count>[,...]" sorted, zero/negative counts dropped; ""
    when nothing is held (the caller then removes the annotation)."""
    return ",".join(
        f"{profile}:{count}"
        for profile, count in sorted(holds.items())
        if count > 0
    )


def parse_migration_hold(value: Optional[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    if not value:
        return out
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        profile, _, count_s = part.rpartition(":")
        try:
            count = int(count_s)
        except ValueError:
            continue
        if profile and count > 0:
            out[profile] = out.get(profile, 0) + count
    return out


def get_migration_hold(annotations: Mapping[str, str]) -> Dict[str, int]:
    return parse_migration_hold(
        annotations.get(constants.ANNOTATION_MIGRATION_HOLD)
    )
