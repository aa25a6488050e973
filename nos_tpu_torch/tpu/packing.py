"""Port of `nos_tpu/tpu/packing.py` (:1-284): `Block` (:27), `Placement` (:40),
`pack` (:160), `packable` (:190), `pack_into` (:227), `free_chips` (:283).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Canonical placement of a geometry onto an ICI mesh.

ICI contiguity is a *graph* constraint the reference never had (NVML owned MIG
placement — SURVEY.md §7 "hard parts"). We solve it with a deterministic
guillotine packer: profiles are placed largest-first, best-fit, splitting free
cuboids along fixed dimension order. Because the algorithm is a pure function
of the geometry multiset, the central planner and every node agent compute the
*same* chip assignment independently — the annotation protocol only ever
carries profile counts, exactly like the reference's (annotations.go:21-58).

Every placement is a contiguous cuboid of the mesh, so each sub-slice gets a
fully connected ICI block (its own torus/mesh for XLA collectives).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

from nos_tpu_torch.tpu.profile import Profile
from nos_tpu_torch.tpu.shape import Shape

Coord = Tuple[int, ...]


@dataclass(frozen=True)
class Block:
    origin: Coord
    dims: Coord

    @property
    def chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


@dataclass(frozen=True)
class Placement:
    """One carved sub-slice: which profile, where, and in which orientation."""

    profile: Profile
    origin: Coord
    dims: Coord  # oriented dims actually placed (a permutation of profile.shape.dims)

    @property
    def chips(self) -> int:
        return self.profile.chips


def _fits(block: Block, want: Coord) -> bool:
    return all(w <= b for w, b in zip(want, block.dims))


def _split(block: Block, want: Coord) -> Tuple[Block, List[Block]]:
    """Guillotine split: carve a `want`-sized corner block at `block.origin`,
    returning it plus the remainder cuboids (split in fixed dim order)."""
    remainders: List[Block] = []
    origin, dims = block.origin, block.dims
    for d in range(len(dims)):
        if dims[d] > want[d]:
            rem_origin = tuple(
                o + (want[d] if i == d else 0) for i, o in enumerate(origin)
            )
            # Along the split dim the remainder is dims[d]-want[d]; dims before
            # d are already reduced to want, dims after d are untouched.
            rem_dims = tuple(
                dims[i] - want[i] if i == d else (want[i] if i < d else dims[i])
                for i in range(len(dims))
            )
            remainders.append(Block(rem_origin, rem_dims))
    return Block(origin, want), remainders


def _place_one(
    free: List[Block],
    profile: Profile,
    allowed_dims: Optional[Tuple[Coord, ...]] = None,
    align: bool = False,
) -> Optional[Placement]:
    """Best-fit: smallest free block (ties: lexicographic origin) and the first
    orientation (canonical order) that fits. `allowed_dims` restricts the
    orientations tried (host-grid packing on anisotropic hosts: only
    rotations that keep the carved chip region congruent are legal).

    With `align`, a block may only sit at origins that are multiples of its
    own dims (buddy-allocator discipline; dims are powers of two per axis).
    Unaligned best-fit can strand a grid permanently: one in-use 4x4 block
    carved at the center of an 8x8 grid leaves no aligned-free 4x4 window
    anywhere, so every later pod-scale carve fails until that workload ends
    — measured as a 2,200s one-gang-at-a-time plateau on the north-star
    trace. Alignment guarantees any in-use block leaves its sibling buddy
    blocks carvable, and matches real TPU sub-slicing, where wraparound
    links constrain sub-slice origins."""
    best = None  # (block_chips, origin, idx, want)
    for idx, block in enumerate(free):
        for orient in profile.shape.orientations():
            want = orient.dims
            if allowed_dims is not None and want not in allowed_dims:
                continue
            if align:
                origin = tuple(
                    ((o + w - 1) // w) * w for o, w in zip(block.origin, want)
                )
                if not all(
                    a + w <= o + d
                    for a, w, o, d in zip(origin, want, block.origin, block.dims)
                ):
                    continue
            else:
                if not _fits(block, want):
                    continue
                origin = block.origin
            key = (block.chips, origin, idx, want)
            if best is None or key < best:
                best = key
            break  # orientations are tried in a fixed order; first fit per block
    if best is None:
        return None
    _, origin, idx, want = best
    block = free.pop(idx)
    if align and origin != block.origin:
        placed = Block(origin, want)
        free.extend(_subtract_block([block], placed))
    else:
        placed, remainders = _split(block, want)
        free.extend(remainders)
    free.sort(key=lambda b: (b.chips, b.origin))
    return Placement(profile, placed.origin, want)


# Memoization: the packer is a pure function of (mesh, geometry multiset), and
# the planner's fork/trial loop re-packs the SAME multisets once per candidate
# node per profile per batch (VERDICT r1 weak #4) — on a v5e-256 control round
# the hit rate dominates. Bounded: cleared wholesale when full (regular control
# rounds cycle through a small working set, so eviction order doesn't matter).
_PACK_CACHE: dict = {}
_PACK_CACHE_LIMIT = 65536
_MISS = object()


def _geometry_key(geometry: Mapping[Profile, int]):
    return tuple(sorted((p.name, n) for p, n in geometry.items() if n > 0))


def _cached(key, compute) -> Optional[List[Placement]]:
    """One memoization policy for both packers: immutable tuple store,
    wholesale clear when full, fresh list per caller."""
    hit = _PACK_CACHE.get(key, _MISS)
    if hit is _MISS:
        result = compute()
        hit = tuple(result) if result is not None else None
        if len(_PACK_CACHE) >= _PACK_CACHE_LIMIT:
            _PACK_CACHE.clear()
        _PACK_CACHE[key] = hit
    return list(hit) if hit is not None else None


def pack(mesh: Shape, geometry: Mapping[Profile, int]) -> Optional[List[Placement]]:
    """Place `geometry` (profile -> count) onto `mesh`; None if it doesn't fit.

    Deterministic: profiles largest-first (ties by name), best-fit free block,
    fixed split order — the canonical placement contract shared by planner and
    agents. Results are memoized by (mesh dims, geometry multiset).
    """
    return _cached(
        (mesh.dims, _geometry_key(geometry)),
        lambda: _pack_uncached(mesh, geometry),
    )


def _pack_uncached(mesh: Shape, geometry: Mapping[Profile, int]) -> Optional[List[Placement]]:
    total = sum(p.chips * n for p, n in geometry.items())
    if total > mesh.chips:
        return None
    free: List[Block] = [Block((0,) * mesh.rank, mesh.dims)]
    placements: List[Placement] = []
    for profile in sorted(geometry, key=lambda p: (-p.chips, p.name)):
        if profile.shape.rank != mesh.rank:
            return None
        for _ in range(geometry[profile]):
            placed = _place_one(free, profile)
            if placed is None:
                return None
            placements.append(placed)
    return placements


def packable(mesh: Shape, geometry: Mapping[Profile, int]) -> bool:
    return pack(mesh, geometry) is not None


def _subtract_block(free: List[Block], occupied: Block) -> List[Block]:
    """Remove `occupied` from a free-cuboid list, splitting overlapped cuboids
    into remainder cuboids (up to 2 per dimension each)."""
    out: List[Block] = []
    for block in free:
        lo = tuple(max(b, o) for b, o in zip(block.origin, occupied.origin))
        hi = tuple(
            min(b + bd, o + od)
            for b, bd, o, od in zip(block.origin, block.dims, occupied.origin, occupied.dims)
        )
        if any(l >= h for l, h in zip(lo, hi)):
            out.append(block)  # no overlap
            continue
        # Slice the block around the intersection, dim by dim.
        cur_origin, cur_dims = list(block.origin), list(block.dims)
        for d in range(len(cur_dims)):
            below = lo[d] - cur_origin[d]
            if below > 0:
                dims = list(cur_dims)
                dims[d] = below
                out.append(Block(tuple(cur_origin), tuple(dims)))
            above = (cur_origin[d] + cur_dims[d]) - hi[d]
            if above > 0:
                origin = list(cur_origin)
                origin[d] = hi[d]
                dims = list(cur_dims)
                dims[d] = above
                out.append(Block(tuple(origin), tuple(dims)))
            cur_origin[d] = lo[d]
            cur_dims[d] = hi[d] - lo[d]
    return out


def pack_into(
    mesh: Shape,
    occupied: List[Tuple[Coord, Coord]],
    geometry: Mapping[Profile, int],
    allowed_dims: Optional[Mapping[Profile, Tuple[Coord, ...]]] = None,
    align: bool = False,
) -> Optional[List[Placement]]:
    """Place `geometry` into the mesh *around* already-placed blocks
    ((origin, dims) pairs). Used by node agents to add slices without moving
    existing ones; None if the addition cannot fit. `allowed_dims` optionally
    restricts the orientations per profile. Memoized like pack(); the
    occupied list is keyed in order (subtraction order shapes the free-cuboid
    decomposition, so order is part of the function's identity)."""
    key = (
        mesh.dims,
        tuple((tuple(o), tuple(d)) for o, d in occupied),
        _geometry_key(geometry),
        tuple(sorted((p.name, dims) for p, dims in (allowed_dims or {}).items())),
        align,
    )
    return _cached(
        key,
        lambda: _pack_into_uncached(mesh, occupied, geometry, allowed_dims, align),
    )


def _pack_into_uncached(
    mesh: Shape,
    occupied: List[Tuple[Coord, Coord]],
    geometry: Mapping[Profile, int],
    allowed_dims: Optional[Mapping[Profile, Tuple[Coord, ...]]] = None,
    align: bool = False,
) -> Optional[List[Placement]]:
    # Chip-count prune before any geometry work (pack() has the same guard;
    # occupied blocks never overlap, so volumes sum).
    needed = sum(p.chips * n for p, n in geometry.items())
    held = sum(Block(tuple(o), tuple(d)).chips for o, d in occupied)
    if needed + held > mesh.chips:
        return None
    free: List[Block] = [Block((0,) * mesh.rank, mesh.dims)]
    for origin, dims in occupied:
        free = _subtract_block(free, Block(tuple(origin), tuple(dims)))
    free.sort(key=lambda b: (b.chips, b.origin))
    placements: List[Placement] = []
    for profile in sorted(geometry, key=lambda p: (-p.chips, p.name)):
        if profile.shape.rank != mesh.rank:
            return None
        restrict = allowed_dims.get(profile) if allowed_dims else None
        for _ in range(geometry[profile]):
            placed = _place_one(free, profile, restrict, align)
            if placed is None:
                return None
            placements.append(placed)
    return placements


def free_chips(mesh: Shape, geometry: Mapping[Profile, int]) -> int:
    return mesh.chips - sum(p.chips * n for p, n in geometry.items())
