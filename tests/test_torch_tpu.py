"""The port's TPU device domain model (`nos_tpu_torch/tpu/`) and the mesh
it becomes (`nos_tpu_torch/parallel/mesh.py::mesh_from_topology`,
`mesh_from_assignment`) against the JAX package's: the cases of
tests/test_tpu_shapes.py, tests/test_tpu_packing.py, tests/test_tpu_mesh.py
(its two `mesh_from_assignment` cases included), the four cases of
tests/test_annotations.py that need `tpu.Profile`, and the cases of
tests/test_multihost.py and tests/test_gpu_modes.py that need only `tpu/`
and `util/`, each run on both packages; then cross-package checks: the
tables equal key for key, `pack`/`pack_into`/`packable`/`free_chips` equal
on every mesh of `KNOWN_SLICE_SHAPES`, `TpuMesh.update_geometry_for` and
`SliceGroup.plan_subslices` equal on the same inputs, and the device
arrangement of `mesh_from_topology`/`mesh_from_assignment` equal to JAX's
for every topology of up to 8 chips. Objects of the two packages never
compare equal, so placements are compared as plain tuples."""

import importlib
import itertools
import random
import types

import numpy as np
import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(120)


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.constants = importlib.import_module(f"{pkg}.constants")
    m.tpu = importlib.import_module(f"{pkg}.tpu")
    m.shape = importlib.import_module(f"{pkg}.tpu.shape")
    m.topology = importlib.import_module(f"{pkg}.tpu.topology")
    m.packing = importlib.import_module(f"{pkg}.tpu.packing")
    m.mesh = importlib.import_module(f"{pkg}.tpu.mesh")
    m.sg = importlib.import_module(f"{pkg}.tpu.slice_group")
    m.ann = importlib.import_module(f"{pkg}.api.annotations")
    m.util = importlib.import_module(f"{pkg}.util")
    m.pmesh = importlib.import_module(f"{pkg}.parallel.mesh")
    m.P = m.tpu.Profile.parse
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


def devices(pkg, n):
    """`n` devices of `pkg`'s runtime: JAX's virtual CPU devices (ids
    0..n-1) for the reference, `cuda:0..n-1` for the port (a
    torch.device needs no CUDA to be built)."""
    if pkg == "nos_tpu":
        import jax

        return jax.devices()[:n]
    import torch

    return [torch.device("cuda", i) for i in range(n)]


def arrangement(pkg, mesh):
    """(axis sizes, device ids laid out on the axes) of either package's
    mesh."""
    if pkg == "nos_tpu":
        ids = np.vectorize(lambda d: d.id, otypes=[int])(mesh.devices)
        return dict(mesh.shape), ids
    ids = np.array([d.index for d in mesh.devices]).reshape(tuple(mesh.shape.values()))
    return dict(mesh.shape), ids


def as_tuples(placements):
    if placements is None:
        return None
    return [(pl.profile.name, tuple(pl.origin), tuple(pl.dims)) for pl in placements]


# -- test_tpu_shapes.py -------------------------------------------------------
def test_shape_parse_and_name(p):
    Shape = p.tpu.Shape
    s = Shape.parse("4x4")
    assert s.dims == (4, 4) and s.chips == 16 and s.rank == 2
    assert Shape.parse("2x2x4").chips == 16
    assert str(Shape((8, 16))) == "8x16"


@pytest.mark.parametrize("bad", ["", "x", "4x", "0x2", "-1x2", "axb"])
def test_shape_parse_invalid(p, bad):
    with pytest.raises(ValueError):
        p.tpu.Shape.parse(bad)


def test_shape_divides_and_orientations(p):
    Shape = p.tpu.Shape
    assert Shape.parse("2x2").divides(Shape.parse("4x4"))
    assert not Shape.parse("3x3").divides(Shape.parse("4x4"))
    assert not Shape.parse("2x2").divides(Shape.parse("2x2x2"))  # rank mismatch
    orientations = {s.name for s in Shape.parse("2x4").orientations()}
    assert orientations == {"2x4", "4x2"}
    assert any(o.divides(Shape.parse("4x4")) for o in Shape.parse("2x4").orientations())


def test_profile_parse_and_resource_roundtrip(p):
    Profile = p.tpu.Profile
    prof = Profile.parse("google.com/tpu-2x2")
    assert prof.name == "2x2" and prof.chips == 4
    assert prof.resource == "google.com/tpu-2x2"
    assert Profile.from_resource("google.com/tpu-2x4").chips == 8
    assert Profile.from_resource("google.com/tpu") is None
    assert Profile.from_resource("nvidia.com/mig-1g.10gb") is None


def test_profile_ordering_smaller_chips_first(p):
    profiles = [p.P(n) for n in ("4x4", "1x1", "2x2", "2x4")]
    assert [x.name for x in sorted(profiles)] == ["1x1", "2x2", "2x4", "4x4"]


def test_profile_memory_gb(p):
    assert p.P("2x2").memory_gb("v5e") == 64  # 4 chips * 16 GB
    assert p.P("1x1x1").memory_gb("v4") == 32


def test_accelerator_generation(p):
    gen = p.tpu.accelerator_generation
    assert gen("tpu-v5-lite-podslice") == "v5e"
    assert gen("tpu-v4-podslice") == "v4"
    assert gen("nvidia-a100") is None


def test_topology_allowed_profiles_v5e_4x4(p):
    t = p.tpu.Topology.parse("v5e", "4x4")
    assert [x.name for x in t.allowed_profiles] == ["1x1", "1x2", "2x2", "2x4", "4x4"]
    assert t.chips == 16 and t.chip_memory_gb == 16


def test_topology_allowed_profiles_v5e_8x8(p):
    t = p.tpu.Topology.parse("v5e", "8x8")
    assert [x.name for x in t.allowed_profiles] == [
        "1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x8",
    ]


def test_topology_allowed_profiles_v4_cube(p):
    t = p.tpu.Topology.parse("v4", "2x2x4")
    assert [x.name for x in t.allowed_profiles] == ["1x1x1", "1x2x2", "2x2x2", "2x2x4"]


def test_topology_from_node_labels(p):
    Topology = p.tpu.Topology
    t = Topology.from_node_labels(
        {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
            "cloud.google.com/gke-tpu-topology": "4x4",
        }
    )
    assert t is not None and t.generation == "v5e" and t.shape.name == "4x4"
    assert Topology.from_node_labels({}) is None


# -- test_tpu_packing.py ------------------------------------------------------
def _cells(placement):
    """All chip coordinates covered by a placement."""
    ranges = [range(o, o + d) for o, d in zip(placement.origin, placement.dims)]
    return set(itertools.product(*ranges))


def assert_valid(mesh, placements, geometry):
    counts = {}
    for pl in placements:
        counts[pl.profile] = counts.get(pl.profile, 0) + 1
    assert counts == {q: n for q, n in geometry.items() if n > 0}
    seen = set()
    for pl in placements:
        cells = _cells(pl)
        assert sorted(pl.dims) == sorted(pl.profile.shape.dims)
        assert not cells & seen, "overlapping placements"
        seen |= cells
        for c in cells:
            assert all(0 <= v < m for v, m in zip(c, mesh.dims))


def test_pack_full_tiling_4x4_with_2x2(p):
    mesh = p.tpu.Shape.parse("4x4")
    geo = {p.P("2x2"): 4}
    placements = p.tpu.pack(mesh, geo)
    assert placements is not None
    assert_valid(mesh, placements, geo)
    assert p.packing.free_chips(mesh, geo) == 0


def test_pack_mixed_profiles(p):
    mesh = p.tpu.Shape.parse("8x8")
    geo = {p.P("4x4"): 2, p.P("2x4"): 2, p.P("2x2"): 3, p.P("1x1"): 4}
    placements = p.tpu.pack(mesh, geo)
    assert placements is not None
    assert_valid(mesh, placements, geo)
    assert p.packing.free_chips(mesh, geo) == 64 - (32 + 16 + 12 + 4)


def test_pack_overflow_rejected(p):
    mesh = p.tpu.Shape.parse("4x4")
    assert p.tpu.pack(mesh, {p.P("4x4"): 1, p.P("1x1"): 1}) is None
    assert p.tpu.pack(mesh, {p.P("2x2"): 5}) is None


def test_pack_shape_constraint_not_just_chip_count(p):
    mesh = p.tpu.Shape.parse("4x4")
    assert p.packing.packable(mesh, {p.P("2x2"): 2, p.P("2x4"): 1})
    assert p.tpu.pack(p.tpu.Shape.parse("4x4"), {p.P("2x2x2"): 1}) is None


def test_pack_3d(p):
    mesh = p.tpu.Shape.parse("2x2x4")
    geo = {p.P("2x2x2"): 1, p.P("1x2x2"): 2}
    placements = p.tpu.pack(mesh, geo)
    assert placements is not None
    assert_valid(mesh, placements, geo)


def test_pack_deterministic(p):
    mesh = p.tpu.Shape.parse("8x8")
    geo = {p.P("2x2"): 3, p.P("4x4"): 1, p.P("2x4"): 1}
    a = p.tpu.pack(mesh, geo)
    b = p.tpu.pack(mesh, {k: v for k, v in reversed(list(geo.items()))})
    assert a == b, "placement must be a pure function of the geometry multiset"


def test_pack_orientation_used_when_needed(p):
    mesh = p.tpu.Shape.parse("4x4")
    geo = {p.P("2x4"): 2}
    placements = p.tpu.pack(mesh, geo)
    assert placements is not None
    assert_valid(mesh, placements, geo)


def test_empty_geometry_packs(p):
    assert p.tpu.pack(p.tpu.Shape.parse("4x4"), {}) == []


def test_pack_into_around_occupied(p):
    mesh = p.tpu.Shape.parse("4x4")
    occupied = [((0, 0), (2, 2))]
    geo = {p.P("2x4"): 1, p.P("1x1"): 2}
    placements = p.packing.pack_into(mesh, occupied, geo)
    assert placements is not None
    cells = set()
    for pl in placements:
        c = _cells(pl)
        assert not c & cells
        cells |= c
    occ = {(x, y) for x in range(2) for y in range(2)}
    assert not cells & occ, "new placements must avoid occupied blocks"


def test_pack_into_fragmentation_fails(p):
    mesh = p.tpu.Shape.parse("4x4")
    occupied = [((0, 0), (1, 1)), ((0, 2), (1, 1)), ((2, 0), (1, 1)), ((2, 2), (1, 1))]
    assert p.packing.pack_into(mesh, occupied, {p.P("2x2"): 1}) is None
    assert p.packing.pack_into(mesh, occupied, {p.P("1x2"): 4}) is not None


# -- test_tpu_mesh.py ---------------------------------------------------------
def v5e_4x4(p, geometry=None, used=None):
    return p.tpu.TpuMesh(p.tpu.Topology.parse("v5e", "4x4"), geometry, used)


def test_invalid_construction(p):
    with pytest.raises(ValueError):
        v5e_4x4(p, {p.P("2x2"): 1}, used={p.P("2x2"): 2})
    with pytest.raises(ValueError):
        v5e_4x4(p, {p.P("2x2"): 5})


def test_free_accounting(p):
    m = v5e_4x4(p, {p.P("2x2"): 3}, used={p.P("2x2"): 1})
    assert m.free == {p.P("2x2"): 2}
    assert m.free_chips == 4
    assert m.has_free_capacity()


def test_can_apply_geometry_never_deletes_used(p):
    P = p.P
    m = v5e_4x4(p, {P("2x2"): 2}, used={P("2x2"): 1})
    assert m.can_apply_geometry({P("2x2"): 1, P("1x1"): 4})
    assert not m.can_apply_geometry({P("1x1"): 8})
    assert not m.can_apply_geometry({P("2x2"): 8})
    with pytest.raises(ValueError):
        m.apply_geometry({P("1x1"): 1})


def test_can_apply_geometry_rejects_disallowed_profile(p):
    m = v5e_4x4(p)
    assert not m.can_apply_geometry({p.P("4x8"): 1})
    assert not m.can_apply_geometry({p.P("3x3"): 1})


def test_update_geometry_for_carves_free_space(p):
    m = v5e_4x4(p)
    assert m.update_geometry_for({p.P("2x2"): 2})
    assert m.geometry == {p.P("2x2"): 2}
    assert m.free == {p.P("2x2"): 2}


def test_update_geometry_for_partial_satisfaction(p):
    m = v5e_4x4(p)
    assert m.update_geometry_for({p.P("2x2"): 6})
    assert m.geometry == {p.P("2x2"): 4}


def test_update_geometry_for_keeps_used_and_repacks_free(p):
    P = p.P
    m = v5e_4x4(p, {P("2x2"): 2, P("1x1"): 2}, used={P("2x2"): 1})
    assert m.update_geometry_for({P("2x4"): 1})
    assert m.geometry[P("2x4")] == 1
    assert m.geometry[P("2x2")] >= 1
    assert m.used == {P("2x2"): 1}


def test_update_geometry_for_no_change_when_impossible(p):
    m = v5e_4x4(p, {p.P("2x2"): 4}, used={p.P("2x2"): 4})
    assert not m.update_geometry_for({p.P("2x4"): 1})
    assert m.geometry == {p.P("2x2"): 4}


def test_update_geometry_for_ignores_disallowed_or_empty(p):
    m = v5e_4x4(p)
    assert not m.update_geometry_for({})
    assert not m.update_geometry_for({p.P("8x8"): 1})
    assert not m.update_geometry_for({p.P("2x2"): 0})


def test_mark_used_and_unused(p):
    m = v5e_4x4(p, {p.P("2x2"): 2})
    m.mark_used(p.P("2x2"))
    assert m.used == {p.P("2x2"): 1}
    with pytest.raises(ValueError):
        m.mark_used(p.P("2x2"), 2)
    m.mark_unused(p.P("2x2"))
    assert m.used == {}
    with pytest.raises(ValueError):
        m.mark_unused(p.P("2x2"))


def test_as_resources_and_clone_independent(p):
    P = p.P
    m = v5e_4x4(p, {P("2x2"): 2, P("1x1"): 1})
    assert m.as_resources() == {"google.com/tpu-2x2": 2, "google.com/tpu-1x1": 1}
    c = m.clone()
    c.mark_used(P("2x2"))
    c.update_geometry_for({P("2x4"): 1})
    assert m.used == {} and m.geometry == {P("2x2"): 2, P("1x1"): 1}


def test_placements_cover_geometry(p):
    m = v5e_4x4(p, {p.P("2x2"): 2, p.P("1x2"): 1})
    pls = m.placements()
    assert pls is not None and len(pls) == 3


def test_mesh_from_assignment_single_slice(p):
    c = p.constants
    labels = {
        c.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
        c.LABEL_TPU_TOPOLOGY: "16x16",
        c.LABEL_TPU_SUBSLICE_TOPOLOGY: "2x4",
    }
    mesh = p.pmesh.mesh_from_assignment(labels, ("dp", "tp"), devices=devices(p.pkg, 8))
    assert dict(mesh.shape) == {"dp": 2, "tp": 4}


def test_mesh_from_assignment_multislice(p):
    c = p.constants
    labels = {
        c.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
        c.LABEL_TPU_SUBSLICE_TOPOLOGY: "2x2",
    }
    mesh = p.pmesh.mesh_from_assignment(
        labels, devices=devices(p.pkg, 8), num_slices=2, ici_axes={"tp": 4},
    )
    assert dict(mesh.shape) == {"dcn": 2, "tp": 4}


# -- test_annotations.py (the cases that need tpu.Profile) --------------------
def test_spec_roundtrip(p):
    specs = p.ann.spec_from_geometry(0, {p.P("2x2"): 2, p.P("1x1"): 3})
    d = p.ann.format_spec(specs)
    assert d == {"tpu.nos/spec-dev-0-1x1": "3", "tpu.nos/spec-dev-0-2x2": "2"}
    assert p.ann.parse_spec(d) == specs


def test_status_roundtrip_and_geometry_counts(p):
    statuses = p.ann.status_from_geometry(0, {p.P("2x2"): 3}, {p.P("2x2"): 1})
    d = p.ann.format_status(statuses)
    assert d == {"tpu.nos/status-dev-0-2x2-used": "1", "tpu.nos/status-dev-0-2x2-free": "2"}
    counts = p.ann.geometry_counts_from_status(p.ann.parse_status(d))
    assert counts == {0: {"2x2": (2, 1)}}


def test_spec_matches_status(p):
    ann, P = p.ann, p.P
    spec = ann.spec_from_geometry(0, {P("2x2"): 2})
    status_ok = ann.status_from_geometry(0, {P("2x2"): 2}, {P("2x2"): 2})
    status_short = ann.status_from_geometry(0, {P("2x2"): 1}, {})
    assert ann.spec_matches_status(spec, status_ok)
    assert not ann.spec_matches_status(spec, status_short)
    status_extra = status_ok + ann.status_from_geometry(1, {}, {})
    assert ann.spec_matches_status(spec, status_extra)
    assert ann.spec_matches_status([], [])


def test_multi_device_indexes(p):
    ann, P = p.ann, p.P
    spec = ann.spec_from_geometry(0, {P("2x2"): 1}) + ann.spec_from_geometry(1, {P("1x1"): 2})
    assert ann.geometry_counts_from_spec(spec) == {0: {"2x2": 1}, 1: {"1x1": 2}}


# -- test_multihost.py and test_gpu_modes.py (the cases of tpu/ and util/) ----
def test_anisotropic_hosts_never_rotate_into_wrong_chip_shape(p):
    """v4-style hosts are 2x2x1 chips: only orientations whose chip region
    stays congruent to the requested profile are planned."""
    topo = p.tpu.Topology.parse("v4", "4x4x4")
    host = p.tpu.Shape.parse("2x2x1")
    hosts = {
        (r, c, d): p.sg.HostInfo(node_name=f"h-{r}-{c}-{d}", coord=(r, c, d), subslice_id=None,
                                 spec_subslice_id=None, reported_plan=True)
        for r in range(2) for c in range(2) for d in range(4)
    }
    group = p.sg.SliceGroup("s0", topo, host, hosts)
    want = p.P("2x2x4")
    planned = group.plan_subslices({want: 1}, lambda n: False)
    assert planned is not None and len(planned) == 1
    chip_dims = tuple(d * h for d, h in zip(planned[0].host_dims, host.dims))
    assert sorted(chip_dims) == sorted(want.shape.dims)


def test_subslice_id_depends_on_orientation(p):
    prof = p.tpu.Profile(p.tpu.Shape((4, 8)))
    a = p.sg.subslice_id_for("s0", prof, (0, 0), (2, 4))
    b = p.sg.subslice_id_for("s0", prof, (0, 0), (4, 2))
    assert a != b
    assert a == p.sg.subslice_id_for("s0", prof, (0, 0), (2, 4))


def test_distinct_permutations_dedupes_and_orders(p):
    perms = list(p.util.distinct_permutations(["b", "a", "a"]))
    assert perms == [["a", "a", "b"], ["a", "b", "a"], ["b", "a", "a"]]
    assert list(p.util.distinct_permutations([])) == [[]]


# -- across packages ----------------------------------------------------------
REF, PORT = load("nos_tpu"), load("nos_tpu_torch")


def test_tables_equal_key_for_key():
    for name in ("_ACCELERATOR_GENERATIONS", "KNOWN_SLICE_SHAPES"):
        assert getattr(PORT.topology, name) == getattr(REF.topology, name), name
    for gen, shapes in REF.topology.KNOWN_SLICE_SHAPES.items():
        for mesh in shapes:
            want = [x.name for x in REF.tpu.Topology.parse(gen, mesh).allowed_profiles]
            got = [x.name for x in PORT.tpu.Topology.parse(gen, mesh).allowed_profiles]
            assert got == want, (gen, mesh)
    for label in list(REF.topology._ACCELERATOR_GENERATIONS) + ["nvidia-h100", ""]:
        assert PORT.tpu.accelerator_generation(label) == REF.tpu.accelerator_generation(label)


def _random_geometry(rng, menu, max_kinds=5, max_count=3):
    geometry = {}
    for _ in range(rng.randint(1, max_kinds)):
        name = rng.choice(menu)
        geometry[name] = geometry.get(name, 0) + rng.randint(1, max_count)
    return geometry


def _geo(m, named):
    return {m.P(n): c for n, c in named.items()}


MESHES = sorted({(gen, mesh) for gen, shapes in
                 importlib.import_module("nos_tpu.tpu.topology").KNOWN_SLICE_SHAPES.items()
                 for mesh in shapes})


@pytest.mark.parametrize("gen,mesh", MESHES)
def test_packing_equal_across_packages(gen, mesh):
    """`pack`, `packable`, `free_chips` and `pack_into` (around the first
    placements of another packing, with and without alignment and with
    restricted orientations) give equal placements on a seeded set of
    geometries drawn from the mesh's menu."""
    rng = random.Random(f"{gen}-{mesh}")
    menu = [x.name for x in REF.tpu.Topology.parse(gen, mesh).allowed_profiles]
    for _ in range(24):
        named = _random_geometry(rng, menu)
        base_named = _random_geometry(rng, menu)
        results = []
        for m in (REF, PORT):
            shape = m.tpu.Shape.parse(mesh)
            geo = _geo(m, named)
            base = m.tpu.pack(shape, _geo(m, base_named))
            occupied = [(pl.origin, pl.dims) for pl in (base or [])[:2]]
            allowed = {q: (q.shape.dims,) for q in geo if q.shape.rank == shape.rank}
            results.append((
                as_tuples(m.tpu.pack(shape, geo)),
                m.packing.packable(shape, geo),
                m.packing.free_chips(shape, geo),
                as_tuples(m.packing.pack_into(shape, occupied, geo)),
                as_tuples(m.packing.pack_into(shape, occupied, geo, align=True)),
                as_tuples(m.packing.pack_into(shape, occupied, geo, allowed, align=True)),
            ))
        assert results[0] == results[1], (gen, mesh, named)


@pytest.mark.parametrize("gen", ["v5e", "v4"])
@pytest.mark.parametrize("pinned", [False, True])
def test_update_geometry_for_equal_across_packages(gen, pinned):
    """From a seeded packable geometry with some slices in use (pinned at
    their canonical placements or counts only), `update_geometry_for` on a
    seeded demand returns the same verdict and geometry in both packages."""
    rng = random.Random(f"{gen}-{pinned}")
    for mesh in REF.topology.KNOWN_SLICE_SHAPES[gen][3:]:
        menu = [x.name for x in REF.tpu.Topology.parse(gen, mesh).allowed_profiles]
        for _ in range(6):
            start = _random_geometry(rng, menu[:-1], max_kinds=3, max_count=2)
            if not REF.packing.packable(REF.tpu.Shape.parse(mesh), _geo(REF, start)):
                continue
            used = {n: rng.randint(0, c) for n, c in start.items()}
            demand = _random_geometry(rng, menu, max_kinds=4, max_count=4)
            reserved = rng.randint(0, 2)
            out = []
            for m in (REF, PORT):
                topo = m.tpu.Topology.parse(gen, mesh)
                pins = None
                if pinned:
                    pls = m.tpu.pack(topo.shape, _geo(m, start))
                    left = dict(used)
                    pins = []
                    for pl in pls:
                        if left.get(pl.profile.name, 0) > 0:
                            left[pl.profile.name] -= 1
                            pins.append((pl.origin, pl.dims))
                tm = m.tpu.TpuMesh(topo, _geo(m, start), _geo(m, used), pins)
                changed = tm.update_geometry_for(_geo(m, demand), reserved_chips=reserved)
                out.append((changed, {q.name: n for q, n in tm.geometry.items()},
                            {q.name: n for q, n in tm.free.items()}, tm.free_chips))
            assert out[0] == out[1], (mesh, start, used, demand)


def _host_group(m, topo, host, carved=()):
    """A SliceGroup over every host of `topo`; `carved` lists
    (subslice id, host coords) already in the spec annotations."""
    grid = m.sg.chip_to_host_block(m.tpu.Profile(m.tpu.Shape.parse(topo.split("-")[1])),
                                   m.tpu.Shape.parse(host))
    spec = {c: sid for sid, coords in carved for c in coords}
    hosts = {
        c: m.sg.HostInfo(node_name="h-" + "-".join(map(str, c)), coord=c, subslice_id=spec.get(c),
                         spec_subslice_id=spec.get(c), reported_plan=True)
        for c in itertools.product(*[range(d) for d in grid.dims])
    }
    gen, shape = topo.split("-")
    return m.sg.SliceGroup("s0", m.tpu.Topology.parse(gen, shape), m.tpu.Shape.parse(host), hosts)


@pytest.mark.parametrize("topo,host", [("v5e-16x16", "2x2"), ("v5p-8x8x8", "2x2x1")])
def test_slice_group_plans_equal_across_packages(topo, host):
    """`SliceGroup.plan_subslices` on a whole pod (64 and 128 hosts) plans
    the same sub-slices (ids, profiles, host blocks, member hosts) for a
    seeded demand, then again around the first plan's blocks held in use."""
    rng = random.Random(topo)
    gen, shape = topo.split("-")
    menu = [x.name for x in REF.tpu.Topology.parse(gen, shape).allowed_profiles]
    for _ in range(4):
        demand = _random_geometry(rng, menu[2:], max_kinds=3, max_count=2)
        plans = []
        for m in (REF, PORT):
            group = _host_group(m, topo, host)
            first = group.plan_subslices(_geo(m, demand), lambda n: False)
            rows = [(s.id, s.profile.name, s.host_origin, s.host_dims, s.hosts) for s in first or []]
            carved = [(s.id, group._block_coords(s.host_origin, s.host_dims)) for s in first or []]
            busy = {h for s in (first or [])[:1] for h in s.hosts}
            regroup = _host_group(m, topo, host, carved)
            second = regroup.plan_subslices(_geo(m, demand), lambda n: n in busy)
            rows2 = [(s.id, s.profile.name, s.host_origin, s.host_dims, s.hosts, s.in_use)
                     for s in second or []]
            plans.append((rows, rows2))
        assert plans[0] == plans[1], demand


def _shapes_up_to(n):
    out = []
    for rank in (1, 2, 3):
        for dims in itertools.product(range(1, n + 1), repeat=rank):
            if int(np.prod(dims)) <= n:
                out.append(dims)
    return out


@pytest.mark.parametrize("axis_names", [("dp",), ("dp", "tp"), ("dp", "tp", "sp"),
                                        ("a", "b", "c", "d")])
def test_mesh_from_topology_lays_devices_out_as_jax(axis_names):
    """Every topology of up to 8 chips (rank 1 to 3), with fewer axes than
    dims (folded into the last axis) and more (padded with size 1): the
    port's mesh has JAX's axis sizes and device arrangement."""
    checked = 0
    for dims in _shapes_up_to(8):
        name = "x".join(map(str, dims))
        got = []
        for m in (REF, PORT):
            topo = m.tpu.Topology.parse("v5e", name)
            mesh = m.pmesh.mesh_from_topology(topo, axis_names, devices(m.pkg, topo.chips))
            shape, ids = arrangement(m.pkg, mesh)
            got.append((list(shape.items()), ids.shape, ids.tolist()))
        assert got[0] == got[1], (name, axis_names)
        checked += 1
    assert checked == len(_shapes_up_to(8))
    with pytest.raises(ValueError):
        PORT.pmesh.mesh_from_topology(PORT.tpu.Topology.parse("v5e", "2x2"), axis_names,
                                      devices("nos_tpu_torch", 3))


@pytest.mark.parametrize("num_slices,ici_axes", [(2, None), (2, {"tp": 4}), (4, {"dp": 1, "tp": 2}),
                                                 (2, {"sp": 2, "tp": -1}), (8, None)])
def test_mesh_from_assignment_multislice_lays_devices_out_as_jax(num_slices, ici_axes):
    """The multislice branch over 8 devices: the same leading "dcn" axis,
    ICI axes and device arrangement as JAX's, for labels with a sub-slice
    topology of the slice's chips."""
    per = 8 // num_slices
    sub = {1: "1x1", 2: "1x2", 4: "2x2", 8: "2x4"}[per]
    got = []
    for m in (REF, PORT):
        labels = {m.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                  m.constants.LABEL_TPU_SUBSLICE_TOPOLOGY: sub}
        mesh = m.pmesh.mesh_from_assignment(labels, devices=devices(m.pkg, 8), num_slices=num_slices,
                                            ici_axes=None if ici_axes is None else dict(ici_axes))
        shape, ids = arrangement(m.pkg, mesh)
        got.append((list(shape.items()), ids.tolist()))
    assert got[0] == got[1]


def test_mesh_from_assignment_labels_equal_across_packages():
    """Labels without a sub-slice topology fall back to the node's mesh
    topology; labels with neither raise in both packages; an unknown
    accelerator reads as v5e."""
    c = REF.constants
    cases = [({c.LABEL_TPU_TOPOLOGY: "2x4"}, 8),
             ({c.LABEL_TPU_ACCELERATOR: "tpu-v4-podslice", c.LABEL_TPU_TOPOLOGY: "2x2x2"}, 8),
             ({c.LABEL_TPU_ACCELERATOR: "nvidia-h100", c.LABEL_TPU_SUBSLICE_TOPOLOGY: "1x4"}, 4)]
    for labels, n in cases:
        got = []
        for m in (REF, PORT):
            mesh = m.pmesh.mesh_from_assignment(labels, ("dp", "tp"), devices=devices(m.pkg, n))
            got.append(arrangement(m.pkg, mesh))
        assert got[0][0] == got[1][0] and got[0][1].tolist() == got[1][1].tolist(), labels
    for m in (REF, PORT):
        with pytest.raises(ValueError, match="no sub-slice or mesh topology"):
            m.pmesh.mesh_from_assignment({}, devices=devices(m.pkg, 1))


def test_mesh_from_topology_without_devices_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are real")
    with pytest.raises(RuntimeError, match="mesh_from_topology runs on CUDA"):
        PORT.pmesh.mesh_from_topology(PORT.tpu.Topology.parse("v5e", "1x1"))
