"""Port of `nos_tpu/tpu/slice_group.py` (:1-444): `HostInfo` (:50), `SubSlice`
(:67), `parse_host_coord` (:78), `format_host_coord` (:82),
`chip_to_host_block` (:86), `subslice_id_for` (:100), `SliceGroup` (:116).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Multi-host podslice model: carve a TPU pod into host-aligned sub-slices.

A multi-host TPU pod (e.g. a v5e-256: 16x16 chips over 64 hosts of 2x2) is
presented by GKE as a node pool — one Node per host VM, each exposing only its
local chips (`google.com/tpu: 4`). Carving such a pod into ICI-contiguous
sub-slices is therefore *host-block* assignment: a 4x8-chip sub-slice is a
2x4 block of hosts, and a workload lands on it as one pod per member host
(gang scheduling).

This is the part of the north star the single-node model cannot express
(SURVEY.md §7 hard parts: "a sub-slice spans hosts — the actuator needs a
slice-level (not node-level) barrier the reference never needed"). The
reference's per-GPU geometry menu (known_configs.go:25-142) becomes the host
grid; its NVML applier (nvml/client.go:225-340) becomes per-host assignment
annotations acknowledged host by host, with re-planning gated on the WHOLE
group having reported the current plan.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Node
from nos_tpu_torch.tpu.packing import pack_into
from nos_tpu_torch.tpu.profile import Profile
from nos_tpu_torch.tpu.shape import Shape
from nos_tpu_torch.tpu.topology import Topology

Coord = Tuple[int, ...]


def _area(dims: Coord) -> int:
    out = 1
    for d in dims:
        out *= d
    return out


def _overlaps(a_origin: Coord, a_dims: Coord, b_origin: Coord, b_dims: Coord) -> bool:
    return all(
        ao < bo + bd and bo < ao + ad
        for ao, ad, bo, bd in zip(a_origin, a_dims, b_origin, b_dims)
    )


@dataclass(frozen=True)
class HostInfo:
    """One member host of a slice group."""

    node_name: str
    coord: Coord  # in host-block units
    subslice_id: Optional[str]  # acknowledged assignment (status side)
    spec_subslice_id: Optional[str]  # desired assignment (spec side)
    reported_plan: bool  # status plan id == spec plan id
    # Declared chip topology of the spec sub-slice (the CANONICAL profile
    # name gang selectors match, e.g. "16x8" carved rotated as an 8x16 host
    # footprint). Geometry alone cannot recover it, and a replan that
    # re-actuates a kept sub-slice with the reconstructed orientation would
    # silently break every selector pointing at the canonical name.
    spec_subslice_topology: Optional[str] = None


@dataclass
class SubSlice:
    """A carved ICI-contiguous block of the global mesh."""

    id: str
    profile: Profile  # chip shape, e.g. 4x8
    host_origin: Coord  # in host units
    host_dims: Coord  # in host units (oriented)
    hosts: List[str] = field(default_factory=list)  # member node names
    in_use: bool = False  # some member host is running a workload pod


def parse_host_coord(value: str) -> Coord:
    return tuple(int(c) for c in value.split(","))


def format_host_coord(coord: Coord) -> str:
    return ",".join(str(c) for c in coord)


def chip_to_host_block(profile: Profile, host: Shape) -> Optional[Shape]:
    """The host-unit footprint of a chip-shaped sub-slice, or None if the
    profile is not host-aligned (every dim must be a multiple of the host
    block — a sub-slice cannot split a host's chips across workloads)."""
    if profile.shape.rank != host.rank:
        return None
    dims = []
    for p, h in zip(profile.shape.dims, host.dims):
        if p % h != 0:
            return None
        dims.append(p // h)
    return Shape(tuple(dims))


def subslice_id_for(
    slice_id: str, profile: Profile, host_origin: Coord, host_dims: Coord
) -> str:
    """Deterministic sub-slice id: same carve -> same id across replans.

    The ORIENTED host footprint is part of the identity: a replan that
    places the same profile at the same origin rotated covers a different
    host set, and reusing the id would let a gang bind onto a mix of the
    old and new footprints during the ack window."""
    key = (
        f"{slice_id}/{profile.name}@{format_host_coord(host_origin)}"
        f"x{format_host_coord(host_dims)}"
    )
    return f"{slice_id}-{hashlib.sha1(key.encode()).hexdigest()[:8]}"


class SliceGroup:
    """Planner-side view of one multi-host podslice."""

    def __init__(
        self,
        slice_id: str,
        topology: Topology,
        host_shape: Shape,
        hosts: Dict[Coord, HostInfo],
    ):
        self.slice_id = slice_id
        self.topology = topology  # global chip mesh
        self.host_shape = host_shape  # chips per host
        self.hosts = hosts
        grid = chip_to_host_block(Profile(topology.shape), host_shape)
        if grid is None:
            raise ValueError(
                f"host block {host_shape} does not tile global mesh {topology.shape}"
            )
        self.host_grid: Shape = grid

    # -- construction --------------------------------------------------------
    @classmethod
    def from_nodes(cls, slice_id: str, nodes: List[Node]) -> "SliceGroup":
        if not nodes:
            raise ValueError("empty slice group")
        first = nodes[0]
        topology = Topology.from_node_labels(first.metadata.labels)
        if topology is None:
            raise ValueError(f"slice {slice_id}: no topology labels")
        host_label = first.metadata.labels.get(constants.LABEL_TPU_HOST_TOPOLOGY)
        if host_label is None:
            raise ValueError(
                f"slice {slice_id}: no {constants.LABEL_TPU_HOST_TOPOLOGY} label"
            )
        host_shape = Shape.parse(host_label)
        hosts: Dict[Coord, HostInfo] = {}
        for node in nodes:
            raw = node.metadata.labels.get(constants.LABEL_TPU_HOST_COORD)
            if raw is None:
                raise ValueError(
                    f"slice {slice_id}: node {node.metadata.name} has no "
                    f"{constants.LABEL_TPU_HOST_COORD} label"
                )
            coord = parse_host_coord(raw)
            if coord in hosts:
                raise ValueError(
                    f"slice {slice_id}: duplicate host coord {raw} "
                    f"({hosts[coord].node_name} vs {node.metadata.name})"
                )
            ann = node.metadata.annotations
            spec_plan = ann.get(constants.ANNOTATION_SPEC_PLAN)
            status_plan = ann.get(constants.ANNOTATION_STATUS_PLAN)
            hosts[coord] = HostInfo(
                node_name=node.metadata.name,
                coord=coord,
                subslice_id=ann.get(constants.ANNOTATION_STATUS_SUBSLICE_ID),
                spec_subslice_id=ann.get(constants.ANNOTATION_SPEC_SUBSLICE_ID),
                reported_plan=spec_plan is None or spec_plan == status_plan,
                spec_subslice_topology=ann.get(
                    constants.ANNOTATION_SPEC_SUBSLICE_TOPOLOGY
                ),
            )
        return cls(slice_id, topology, host_shape, hosts)

    # -- state ---------------------------------------------------------------
    def all_reported(self) -> bool:
        """The slice-level barrier: every member host has acknowledged the
        current plan (node-level handshakes are not enough — a sub-slice
        spans hosts, so acting on a half-acknowledged group could tear a
        workload's mesh)."""
        return all(h.reported_plan for h in self.hosts.values())

    def current_subslices(self, node_has_workload) -> List[SubSlice]:
        """Reconstruct carved sub-slices from per-host spec annotations (the
        desired state is the database; status lags only via the barrier)."""
        by_id: Dict[str, List[HostInfo]] = {}
        for h in self.hosts.values():
            if h.spec_subslice_id:
                by_id.setdefault(h.spec_subslice_id, []).append(h)
        out = []
        for sid, members in by_id.items():
            coords = [m.coord for m in members]
            origin = tuple(min(c[i] for c in coords) for i in range(len(coords[0])))
            upper = tuple(max(c[i] for c in coords) + 1 for i in range(len(coords[0])))
            dims = tuple(u - o for o, u in zip(origin, upper))
            chip_dims = tuple(
                d * h for d, h in zip(dims, self.host_shape.dims)
            )
            # Prefer the DECLARED topology (canonical orientation — what gang
            # selectors match) over the geometric reconstruction: a kept
            # sub-slice re-actuated with the oriented name would break the
            # selector of the very gang it was carved for (a "16x8" carve
            # placed rotated reconstructs as "8x16").
            profile = Profile(Shape(chip_dims))
            declared = next(
                (m.spec_subslice_topology for m in members if m.spec_subslice_topology),
                None,
            )
            if declared:
                try:
                    declared_profile = Profile.parse(declared)
                    if sorted(declared_profile.shape.dims) == sorted(chip_dims):
                        profile = declared_profile
                except ValueError:
                    pass
            out.append(
                SubSlice(
                    id=sid,
                    profile=profile,
                    host_origin=origin,
                    host_dims=dims,
                    hosts=[m.node_name for m in members],
                    in_use=any(node_has_workload(m.node_name) for m in members),
                )
            )
        return out

    # -- planning ------------------------------------------------------------
    def plan_subslices(
        self,
        demand: Dict[Profile, int],
        node_has_workload,
    ) -> Optional[List[SubSlice]]:
        """Carve sub-slices for `demand` (chip profiles -> count): keep every
        in-use sub-slice pinned where it is, drop free ones if they block, and
        pack the new blocks onto the host grid. Returns the FULL desired
        sub-slice list (kept + new), or None if nothing new could be placed."""
        current = self.current_subslices(node_has_workload)
        pinned = [s for s in current if s.in_use]
        free = [s for s in current if not s.in_use]
        occupied = [(s.host_origin, s.host_dims) for s in pinned]

        # Host-unit footprints for the demanded profiles.
        wanted: Dict[Profile, Tuple[Profile, int]] = {}
        for profile, count in demand.items():
            block = chip_to_host_block(profile, self.host_shape)
            if block is None or not any(
                o.fits_in(self.host_grid) for o in block.orientations()
            ):
                continue
            wanted[Profile(block)] = (profile, count)
        if not wanted:
            return None

        counts = {bp: c for bp, (_, c) in wanted.items()}
        # Rotating a host block is only legal when the carved CHIP region
        # stays congruent to the requested profile. On uniform hosts (v5e
        # 2x2) every rotation qualifies; on anisotropic hosts (v4/v5p 2x2x1)
        # only chip-profile orientations that stay host-aligned do.
        allowed: Dict[Profile, Tuple[Coord, ...]] = {
            bp: self._allowed_block_dims(chip_profile)
            for bp, (chip_profile, _) in wanted.items()
        }

        # Attempt ladder (the agent-side delete-free-then-retry heuristic,
        # lifted to hosts): (1) full pack keeping free sub-slices in place,
        # (2) full pack dropping them, (3) partial pack with them dropped —
        # never settle for a partial keep-free pack when dropping free
        # sub-slices could satisfy everything.
        occ_keep = occupied + [(s.host_origin, s.host_dims) for s in free]
        keep_free: List[SubSlice] = list(free)
        placements = pack_into(self.host_grid, occ_keep, counts, allowed, align=True)
        if placements is None:
            keep_free = []
            placements = pack_into(self.host_grid, list(occupied), counts, allowed, align=True)
        if placements is None:
            placements = []
            occ2 = list(occupied)
            # Partial pack honors DEMAND order (the caller sorts demand in
            # the scheduler's bind order), not size order: carving a large
            # low-priority block first can cover the grid and deadlock the
            # higher-priority gang the scheduler insists on binding first.
            for bp in counts:
                for _ in range(counts[bp]):
                    got = pack_into(self.host_grid, occ2, {bp: 1}, allowed, align=True)
                    if got:
                        placements.extend(got)
                        occ2.extend((pl.origin, pl.dims) for pl in got)
        if not placements:
            return None

        result = list(pinned) + keep_free
        for pl in placements:
            chip_profile, _ = wanted[pl.profile]
            hosts = [
                self.hosts[c].node_name
                for c in self._block_coords(pl.origin, pl.dims)
                if c in self.hosts
            ]
            result.append(
                SubSlice(
                    id=subslice_id_for(
                        self.slice_id, chip_profile, pl.origin, pl.dims
                    ),
                    profile=chip_profile,
                    host_origin=pl.origin,
                    host_dims=pl.dims,
                    hosts=hosts,
                )
            )
        return result

    def _allowed_block_dims(self, chip_profile: Profile) -> Tuple[Coord, ...]:
        """Host-unit footprints (oriented) whose chip region stays congruent
        to `chip_profile` AND host-aligned — the legal rotations of its host
        block on this group's grid."""
        dims_set = []
        for o in chip_profile.shape.orientations():
            if all(c % h == 0 for c, h in zip(o.dims, self.host_shape.dims)):
                dims_set.append(
                    tuple(c // h for c, h in zip(o.dims, self.host_shape.dims))
                )
        return tuple(dims_set)

    # -- defragmentation (sub-slice migration) -------------------------------
    def plan_defrag(
        self,
        profile: Profile,
        node_has_workload,
        movable,
        max_movers: int = 8,
    ):
        """Search for ONE sub-slice migration that unblocks a `profile` carve
        this grid cannot host today: pick an in-use mover sub-slice (smallest
        host footprint first, `movable` filters to whole checkpointable
        gangs etc.), place the demanded block as if the mover's block were
        free, then place the mover's OWN block at a destination that
        overlaps neither the remaining pinned blocks, the demanded block,
        nor the mover's current block — the create-destination-first
        requirement of the move protocol (source and destination must
        coexist while the gang drains). Free sub-slices are dropped unless
        they survive without overlapping the new carves.

        Returns (desired_subslices, mover, dest_subslice, pending_subslice)
        or None when no single migration coalesces a window."""
        current = self.current_subslices(node_has_workload)
        pinned = [s for s in current if s.in_use]
        free = [s for s in current if not s.in_use]
        block = chip_to_host_block(profile, self.host_shape)
        if block is None:
            return None
        target_bp = Profile(block)
        target_allowed = self._allowed_block_dims(profile)
        if not target_allowed:
            return None

        movers = sorted(
            (s for s in pinned if movable(s)),
            key=lambda s: (_area(s.host_dims), s.id),
        )
        for mover in movers[:max_movers]:
            others = [s for s in pinned if s.id != mover.id]
            occ_others = [(s.host_origin, s.host_dims) for s in others]
            pend_pl = pack_into(
                self.host_grid,
                occ_others,
                {target_bp: 1},
                {target_bp: target_allowed},
                align=True,
            )
            if not pend_pl:
                continue
            mover_block = chip_to_host_block(mover.profile, self.host_shape)
            if mover_block is None:
                continue
            mover_bp = Profile(mover_block)
            occ_dest = (
                occ_others
                + [(pl.origin, pl.dims) for pl in pend_pl]
                + [(mover.host_origin, mover.host_dims)]
            )
            dest_pl = pack_into(
                self.host_grid,
                occ_dest,
                {mover_bp: 1},
                {mover_bp: self._allowed_block_dims(mover.profile)},
                align=True,
            )
            if not dest_pl:
                continue
            pending_ss = self._subslice_at(profile, pend_pl[0])
            dest_ss = self._subslice_at(mover.profile, dest_pl[0])
            carves = [
                (pending_ss.host_origin, pending_ss.host_dims),
                (dest_ss.host_origin, dest_ss.host_dims),
            ]
            kept_free = [
                s
                for s in free
                if not any(
                    _overlaps(s.host_origin, s.host_dims, o, d)
                    for o, d in carves
                )
            ]
            desired = others + kept_free + [dest_ss, pending_ss]
            return desired, mover, dest_ss, pending_ss
        return None

    def _subslice_at(self, chip_profile: Profile, placement) -> SubSlice:
        return SubSlice(
            id=subslice_id_for(
                self.slice_id, chip_profile, placement.origin, placement.dims
            ),
            profile=chip_profile,
            host_origin=placement.origin,
            host_dims=placement.dims,
            hosts=[
                self.hosts[c].node_name
                for c in self._block_coords(placement.origin, placement.dims)
                if c in self.hosts
            ],
        )

    def _block_coords(self, origin: Coord, dims: Coord) -> List[Coord]:
        coords: List[Coord] = [()]
        for o, d in zip(origin, dims):
            coords = [c + (o + i,) for c in coords for i in range(d)]
        return coords

    def assignment(self, subslices: List[SubSlice]) -> Dict[str, Optional[SubSlice]]:
        """node name -> its sub-slice (None = unassigned)."""
        out: Dict[str, Optional[SubSlice]] = {
            h.node_name: None for h in self.hosts.values()
        }
        for s in subslices:
            for name in s.hosts:
                out[name] = s
        return out
