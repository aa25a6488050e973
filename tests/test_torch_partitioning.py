"""The port's partitioning plane (`nos_tpu_torch/partitioning/`, `gpu/`, and
the controllers that drive it: `controllers/{partitioner,tpu_agent,
gpu_agent}.py`) against the JAX package's.

- The cases of tests/test_planner.py, test_planner_adversarial.py,
  test_cluster_state.py, test_e2e_partitioning.py, test_gpu_modes.py (all
  but `test_cli_gpu_agent_modes_start`, which needs `cli`, and
  `test_distinct_permutations_dedupes_and_orders`, which
  test_torch_tpu.py holds) and the first scenario of test_perf_planner.py
  (`test_control_round_v5e_256_as_four_hosts`, its 2.0 s ceiling kept),
  each run on both packages with the reference's assertions: every name
  the reference imports from `nos_tpu` is read from the package under test
  (`pk.<name>`), and every helper takes that namespace first.
- Across packages, exact equality once the plan ids are stripped:
  test_perf_planner.py's 100-pod backlog (seed 0) after one control round
  on 4 x v5e 8x8 and on 1 x 16x16 (per-node spec and status annotations,
  allocatable, and the pods that then fit); an MPS node and a MIG node
  (`NVIDIA-A100-SXM4-40GB`) under a mixed backlog (agent devices,
  annotations, allocatable, the device-plugin configs); and a MIG-mode node
  labelled `NVIDIA-H100-80GB-HBM3`, which neither package plans (the port
  keeps the reference's MIG tables: A30 and A100 only).

Each package keeps its own module-level state (the MIG geometry overrides,
the `observability.metrics` registry, `tpu/packing._PACK_CACHE`); the `pk`
fixture resets both packages' copies before every case. Clocks are the
reference tests' fake clocks, and each test has a limit (SIGALRM)."""

import importlib
import json
import random
import time
import types

import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(60)

# What the reference files import from `nos_tpu`, by module ("name as
# alias" where they rename).
NAMES = {
    "": ["constants"],
    "api": ["annotations as ann"],
    "api.objects": ["Container", "Node", "NodeStatus", "ObjectMeta", "Pod", "PodCondition",
                    "PodPhase", "PodSpec"],
    "api.resources": ["ResourceList", "ResourceList as RL", "compute_pod_request"],
    "cluster": ["Cluster"],
    "controllers.gpu_agent": ["FakeGpuDeviceClient", "GpuAgent", "hybrid_parse_profile",
                              "hybrid_resource_of", "hybrid_validator", "mig_validator",
                              "mps_validator"],
    "controllers.partitioner": ["PartitionerController"],
    "controllers.tpu_agent": ["TpuAgent"],
    "gpu.device_plugin": ["DevicePluginClient", "FakeDevicePluginDaemonSet",
                          "RestartTimeoutError"],
    "gpu.mig": ["KNOWN_MIG_MODELS", "MigGpu", "MigProfile", "allowed_geometries",
                "clear_known_geometry_overrides", "geometry_allowed", "geometry_feasible",
                "model_known", "set_known_geometries"],
    "gpu.mps": ["MpsGpu", "MpsProfile"],
    "partitioning.core": ["Actuator", "Planner", "Snapshot"],
    "partitioning.core.interface": ["FitSimScheduler", "partitioning_equal"],
    "partitioning.core.planner": ["PartitioningPlan"],
    "partitioning.gpu_modes": ["GpuNode", "MigPartitioner", "MigSliceSpec", "MigSnapshotTaker",
                               "MpsPartitioner", "MpsSnapshotTaker", "_parses_as",
                               "hybrid_contended_indexes"],
    "partitioning.state": ["ClusterState"],
    "partitioning.tpu_mode": ["TpuNode", "TpuPartitioner", "TpuSliceSpec", "TpuSnapshotTaker"],
    "tpu": ["Profile", "Topology", "TpuMesh"],
    "tpulib": ["FakeTpuClient"],
    "tpulib.interface": ["TpuLibError"],
    "util": ["distinct_permutations"],
}


def load(pkg):
    """The names of NAMES from package `pkg`, as one namespace."""
    ns = types.SimpleNamespace(pkg=pkg)
    for sub, names in NAMES.items():
        module = importlib.import_module(f"{pkg}.{sub}" if sub else pkg)
        for entry in names:
            name, _, alias = entry.partition(" as ")
            value = getattr(module, name, None)
            if value is None:
                value = importlib.import_module(f"{module.__name__}.{name}")
            setattr(ns, alias or name, value)
    ns.metrics = importlib.import_module(f"{pkg}.observability").metrics
    ns.packing = importlib.import_module(f"{pkg}.tpu.packing")
    return ns


NAMESPACES = {pkg: load(pkg) for pkg in PACKAGES}


def reset(ns):
    """One package's module-level state back to its import-time value."""
    ns.clear_known_geometry_overrides()
    ns.metrics.__init__()
    ns.packing._PACK_CACHE.clear()


@pytest.fixture(params=PACKAGES)
def pk(request):
    for ns in NAMESPACES.values():
        reset(ns)
    return NAMESPACES[request.param]


# -- test_planner.py ----------------------------------------------------------
def P(pk, name):
    return pk.Profile.parse(name)


def tpu_node(pk, name, topo="4x4", gen="v5e", geometry=None, used=None, cpu=64, requested=None):
    mesh = pk.TpuMesh(pk.Topology.parse(gen, topo), geometry, used)
    return pk.TpuNode(
        name=name,
        mesh=mesh,
        labels={pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU},
        base_allocatable=pk.ResourceList.of({"cpu": cpu}),
        requested=requested,
    )


def slice_pod(pk, name, profile, count=1, cpu="100m", priority=0, ns="default"):
    return pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns),
        spec=pk.PodSpec(
            containers=[
                pk.Container(
                    resources=pk.ResourceList.of(
                        {f"google.com/tpu-{profile}": count, "cpu": cpu}
                    )
                )
            ],
            priority=priority,
        ),
    )


def make_snapshot(pk, *nodes):
    return pk.Snapshot({n.name: n for n in nodes}, pk.TpuSliceSpec())


def planner(pk):
    return pk.Planner(pk.FitSimScheduler())


def test_plan_carves_profile_for_single_pod(pk):
    snap = make_snapshot(pk, tpu_node(pk, "n1"))
    plan = planner(pk).plan(snap, [slice_pod(pk, "p1", "2x2")])
    assert plan.state["n1"][0].get("2x2", 0) >= 1
    # The placed pod occupies the slice in the snapshot.
    assert snap.get_node("n1").mesh.used == {P(pk, "2x2"): 1}


def test_plan_no_change_when_no_slice_pods(pk):
    whole_chip_pod = pk.Pod(
        metadata=pk.ObjectMeta(name="whole", namespace="default"),
        spec=pk.PodSpec(
            containers=[pk.Container(resources=pk.ResourceList.of({"google.com/tpu": 4}))]
        ),
    )
    node = tpu_node(pk, "n1")
    snap = make_snapshot(pk, node)
    plan = planner(pk).plan(snap, [whole_chip_pod])
    assert pk.partitioning_equal(plan.state["n1"], {0: {}})


def test_plan_no_change_when_slices_already_free(pk):
    # A free 2x2 already exists -> nothing lacking -> geometry untouched.
    node = tpu_node(pk, "n1", geometry={P(pk, "2x2"): 1})
    snap = make_snapshot(pk, node)
    plan = planner(pk).plan(snap, [slice_pod(pk, "p1", "2x2")])
    assert plan.state["n1"] == {0: {"2x2": 1}}


def test_plan_packs_multiple_pods_one_node(pk):
    snap = make_snapshot(pk, tpu_node(pk, "n1"))
    pods = [slice_pod(pk, f"p{i}", "2x2") for i in range(4)]
    plan = planner(pk).plan(snap, pods)
    assert plan.state["n1"][0]["2x2"] == 4
    assert snap.get_node("n1").mesh.used == {P(pk, "2x2"): 4}


def test_plan_overflows_to_second_node(pk):
    snap = make_snapshot(pk, tpu_node(pk, "n1"), tpu_node(pk, "n2"))
    pods = [slice_pod(pk, f"p{i}", "2x2") for i in range(6)]
    plan = planner(pk).plan(snap, pods)
    total = plan.state["n1"][0].get("2x2", 0) + plan.state["n2"][0].get("2x2", 0)
    assert total >= 6
    used1 = snap.get_node("n1").mesh.used.get(P(pk, "2x2"), 0)
    used2 = snap.get_node("n2").mesh.used.get(P(pk, "2x2"), 0)
    assert used1 + used2 == 6


def test_plan_respects_used_slices(pk):
    # Node full of used slices: nothing can be re-carved.
    node = tpu_node(pk, "n1", geometry={P(pk, "2x2"): 4}, used={P(pk, "2x2"): 4})
    snap = make_snapshot(pk, node)
    plan = planner(pk).plan(snap, [slice_pod(pk, "p1", "2x4")])
    assert plan.state["n1"] == {0: {"2x2": 4}}


def test_plan_respects_whole_chip_reservations(pk):
    # 12 of 16 chips held by whole-chip pods -> only one 2x2 can be carved.
    node = tpu_node(pk, 
        "n1", requested=pk.ResourceList.of({pk.constants.RESOURCE_TPU: 12, "cpu": 1})
    )
    snap = make_snapshot(pk, node)
    pods = [slice_pod(pk, f"p{i}", "2x2") for i in range(3)]
    plan = planner(pk).plan(snap, pods)
    assert plan.state["n1"][0].get("2x2", 0) == 1


def test_plan_respects_cpu_capacity(pk):
    # Node has 1 cpu; second pod needs 0.8 cpu -> only one fits.
    snap = make_snapshot(pk, tpu_node(pk, "n1", cpu=1))
    pods = [slice_pod(pk, "p1", "2x2", cpu="800m"), slice_pod(pk, "p2", "2x2", cpu="800m")]
    plan = planner(pk).plan(snap, pods)
    node = snap.get_node("n1")
    assert node.mesh.used.get(P(pk, "2x2"), 0) == 1  # only one pod placed
    # Geometry may still expose extra carved slices for the future, but only
    # one is in use.


def test_plan_priority_order(pk):
    # CPU only allows one of the two pods; the high-priority pod wins.
    snap = make_snapshot(pk, tpu_node(pk, "n1", cpu=1))
    lo = slice_pod(pk, "lo", "2x2", priority=1, cpu="800m")
    hi = slice_pod(pk, "hi", "2x2", priority=10, cpu="800m")
    plan = planner(pk).plan(snap, [lo, hi])
    node = snap.get_node("n1")
    assert node.mesh.used == {P(pk, "2x2"): 1}
    assert [p.metadata.name for p in node.pods] == ["hi"]


def test_plan_mixed_profiles_smaller_first_among_equal_priority(pk):
    snap = make_snapshot(pk, tpu_node(pk, "n1"))
    pods = [slice_pod(pk, "big", "2x4"), slice_pod(pk, "small", "1x1")]
    plan = planner(pk).plan(snap, pods)
    node = snap.get_node("n1")
    assert node.mesh.used == {P(pk, "2x4"): 1, P(pk, "1x1"): 1}


def test_actuator_applies_only_changed_nodes(pk):
    applied_calls = []

    class RecordingPartitioner:
        def apply_partitioning(self, node_name, plan_id, partitioning):
            applied_calls.append((node_name, partitioning))

    current = {
        "n1": {0: {"2x2": 2}},
        "n2": {0: {}},
    }
    plan = pk.PartitioningPlan(
        state={
            "n1": {0: {"2x2": 2}},  # unchanged
            "n2": {0: {"2x2": 1}},  # changed
        },
        id="plan-1",
    )
    actuator = pk.Actuator(RecordingPartitioner(), lambda n: current[n])
    result = actuator.apply(plan)
    assert result == {"n1": False, "n2": True}
    assert applied_calls == [("n2", {0: {"2x2": 1}})]


def test_partitioning_equal_ignores_zero_and_empty(pk):
    assert pk.partitioning_equal({0: {}}, {})
    assert pk.partitioning_equal({0: {"2x2": 0}}, {})
    assert pk.partitioning_equal({0: {"2x2": 1}}, {0: {"2x2": 1}})
    assert not pk.partitioning_equal({0: {"2x2": 1}}, {0: {"2x2": 2}})


# -- test_planner_adversarial.py ----------------------------------------------
def adv_tpu_node(pk, name, topo="4x4", geometry=None, used=None, cpu=64, pinned=None):
    mesh = pk.TpuMesh(pk.Topology.parse("v5e", topo), geometry, used, pinned=pinned)
    return pk.TpuNode(
        name=name,
        mesh=mesh,
        labels={pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU},
        base_allocatable=pk.ResourceList.of({"cpu": cpu}),
    )


def adv_slice_pod(pk, name, profile, count=1, cpu="100m", priority=0, ns="default"):
    return pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns),
        spec=pk.PodSpec(
            containers=[
                pk.Container(
                    resources=pk.ResourceList.of(
                        {f"google.com/tpu-{profile}": count, "cpu": cpu}
                    )
                )
            ],
            priority=priority,
        ),
    )


def adv_plan(pk, nodes, pods):
    snapshot = pk.Snapshot({n.name: n for n in nodes}, pk.TpuSliceSpec())
    return pk.Planner(pk.FitSimScheduler()).plan(snapshot, pods), snapshot


# -- pathological shapes ------------------------------------------------------
def test_demand_larger_than_any_node_mesh_places_nothing(pk):
    """An 8x8 request on a cluster of 4x4 nodes can never bind; the plan must
    not thrash geometries chasing it."""
    nodes = [adv_tpu_node(pk, f"n{i}") for i in range(4)]
    result, snapshot = adv_plan(pk, nodes, [adv_slice_pod(pk, "impossible", "8x8")])
    assert result.placed == set()
    for node in snapshot.nodes.values():
        assert node.mesh.geometry == {}


def test_zero_quantity_slice_request_is_ignored(pk):
    node = adv_tpu_node(pk, "n0")
    result, _ = adv_plan(pk, [node], [adv_slice_pod(pk, "zero", "2x2", count=0)])
    # A zero-count request carries no slice demand: nothing to carve.
    assert node.mesh.geometry == {}


def test_duplicate_pod_names_across_namespaces_both_place(pk):
    """Identity is namespace/name: the same name in two namespaces must not
    collapse into one placement."""
    nodes = [adv_tpu_node(pk, "n0", "4x4")]
    pods = [
        adv_slice_pod(pk, "same", "2x2", ns="team-a"),
        adv_slice_pod(pk, "same", "2x2", ns="team-b"),
    ]
    result, _ = adv_plan(pk, nodes, pods)
    assert result.placed == {"team-a/same", "team-b/same"}


def test_fragmentation_trap_prefers_feasible_packing(pk):
    """Four 1x1 pods + one 4x4 pod on two 4x4 nodes: if the planner scatters
    the 1x1s across both nodes, the 4x4 can never fit. The node-by-node
    commit order packs the small slices onto one node, leaving the other
    whole."""
    nodes = [adv_tpu_node(pk, "a"), adv_tpu_node(pk, "b")]
    pods = [adv_slice_pod(pk, f"s{i}", "1x1") for i in range(4)] + [adv_slice_pod(pk, "big", "4x4")]
    result, snapshot = adv_plan(pk, nodes, pods)
    assert len(result.placed) == 5, f"placed only {result.placed}"
    geoms = sorted(
        tuple(sorted((p.name, n) for p, n in node.mesh.geometry.items()))
        for node in snapshot.nodes.values()
    )
    assert (("4x4", 1),) in geoms


def test_pinned_wall_blocks_and_planner_respects_it(pk):
    """A pinned in-use 1x1 in the mesh center of every node: counts say a
    2x2 fits, placement says no. The planner must not emit an unactuatable
    carve."""
    center_pin = [((1, 1), (1, 1))]
    nodes = [
        adv_tpu_node(pk, 
            f"n{i}", "3x3", geometry={P(pk, "1x1"): 1},
            used={P(pk, "1x1"): 1}, pinned=center_pin,
        )
        for i in range(2)
    ]
    result, snapshot = adv_plan(pk, nodes, [adv_slice_pod(pk, "p", "2x2")])
    for node in snapshot.nodes.values():
        assert node.mesh.geometry.get(P(pk, "2x2"), 0) == 0


def test_pod_requesting_two_profiles_needs_both_on_one_node(pk):
    nodes = [
        adv_tpu_node(pk, "small", "2x2"),  # can host 2x2 only
        adv_tpu_node(pk, "big", "4x4"),  # can host both
    ]
    pod = pk.Pod(
        metadata=pk.ObjectMeta(name="both", namespace="ml"),
        spec=pk.PodSpec(
            containers=[
                pk.Container(
                    resources=pk.ResourceList.of(
                        {"google.com/tpu-2x2": 1, "google.com/tpu-2x4": 1, "cpu": 1}
                    )
                )
            ]
        ),
    )
    result, snapshot = adv_plan(pk, nodes, [pod])
    assert result.placed == {"ml/both"}
    big = snapshot.nodes["big"]
    assert big.mesh.geometry.get(P(pk, "2x2"), 0) >= 1
    assert big.mesh.geometry.get(P(pk, "2x4"), 0) >= 1


def test_cpu_starved_node_is_skipped_despite_chip_room(pk):
    nodes = [adv_tpu_node(pk, "starved", cpu=0.05), adv_tpu_node(pk, "ok")]
    result, snapshot = adv_plan(pk, [nodes[0], nodes[1]], [adv_slice_pod(pk, "p", "2x2", cpu="500m")])
    assert result.placed == {"default/p"}
    assert snapshot.nodes["starved"].mesh.geometry == {}
    assert snapshot.nodes["ok"].mesh.geometry.get(P(pk, "2x2"), 0) >= 1


# -- scale sweeps -------------------------------------------------------------
def test_64_node_sweep_places_every_feasible_pod(pk):
    """64 x 4x4 nodes (1024 chips), 192 pods totalling exactly 768 chips of
    mixed demand: every pod is feasible and must place in ONE plan call."""
    rng = random.Random(42)
    nodes = [adv_tpu_node(pk, f"n{i:02d}") for i in range(64)]
    pods = []
    # 64 of each: 1x1, 2x2, plus 32 4x4 + 32 1x2 = 64+256+512... build to fit:
    for i in range(64):
        pods.append(adv_slice_pod(pk, f"one-{i}", "1x1"))
    for i in range(64):
        pods.append(adv_slice_pod(pk, f"four-{i}", "2x2"))
    for i in range(28):
        pods.append(adv_slice_pod(pk, f"whole-{i}", "4x4"))
    rng.shuffle(pods)
    result, snapshot = adv_plan(pk, nodes, pods)
    total_chips = 64 * 1 + 64 * 4 + 28 * 16  # = 768 <= 1024
    assert total_chips <= 1024
    assert len(result.placed) == len(pods), (
        f"{len(pods) - len(result.placed)} pods unplaced"
    )


def test_64_node_oversubscribed_sweep_places_exactly_capacity(pk):
    """Demand is 2x capacity in whole-mesh units: exactly node-count pods can
    place, never more (no overcommit), and high priority wins."""
    nodes = [adv_tpu_node(pk, f"n{i:02d}") for i in range(64)]
    pods = [
        adv_slice_pod(pk, f"lo-{i}", "4x4", priority=0) for i in range(64)
    ] + [adv_slice_pod(pk, f"hi-{i}", "4x4", priority=10) for i in range(64)]
    result, _ = adv_plan(pk, nodes, pods)
    assert len(result.placed) == 64
    assert all(name.startswith("default/hi-") for name in result.placed)


def test_best_fit_orders_by_true_free_capacity_in_every_mode(pk):
    """An untouched device must sort LAST (its whole budget is free) — a
    naive resource-name heuristic counted unpartitioned GPUs as zero free
    units and carved up empty devices before reusing existing free slices."""

    g1 = pk.MigProfile.parse("1g.5gb")
    # Both the spec-listed spelling AND an alias-only spelling (absent from
    # KNOWN_MIG_MODELS, resolved through the geometry tables) must order
    # correctly — the budget lookup may not silently return zero.
    for model in ("NVIDIA-A100-PCIE-40GB", "NVIDIA-A100-SXM4-40GB"):
        empty_gpu = pk.MigGpu(model, 0)  # whole 40GB budget free
        sliced_gpu = pk.MigGpu(model, 0, {g1: 7}, used={g1: 6})  # one free 5GB slice
        assert empty_gpu.free_capacity_gb() >= 35.0, model
        node_empty = pk.GpuNode("empty", [empty_gpu], pk.MigProfile.from_resource)
        node_sliced = pk.GpuNode("sliced", [sliced_gpu], pk.MigProfile.from_resource)
        snap = pk.Snapshot({"empty": node_empty, "sliced": node_sliced}, pk.MigSliceSpec())
        order = [n.name for n in snap.get_candidate_nodes()]
        assert order == ["sliced", "empty"], (model, order)

    # TPU: uncarved chips count too.
    t_empty = adv_tpu_node(pk, "t-empty")  # 16 free chips
    t_partial = adv_tpu_node(pk, "t-partial", geometry={P(pk, "2x2"): 3}, used={P(pk, "2x2"): 2})
    snap2 = pk.Snapshot({"t-empty": t_empty, "t-partial": t_partial}, pk.TpuSliceSpec())
    order2 = [n.name for n in snap2.get_candidate_nodes()]
    assert order2 == ["t-partial", "t-empty"], order2


def test_plan_is_deterministic_across_input_order(pk):
    """The same pod set in a different submission order yields the same
    placements and the same final geometries (canonical sorting)."""

    def run(order_seed):
        rng = random.Random(order_seed)
        nodes = [adv_tpu_node(pk, f"n{i}") for i in range(8)]
        pods = (
            [adv_slice_pod(pk, f"a-{i}", "1x1") for i in range(8)]
            + [adv_slice_pod(pk, f"b-{i}", "2x2") for i in range(8)]
            + [adv_slice_pod(pk, f"c-{i}", "2x4") for i in range(4)]
        )
        rng.shuffle(pods)
        result, snapshot = adv_plan(pk, nodes, pods)
        geoms = {
            name: tuple(sorted((p.name, n) for p, n in node.mesh.geometry.items()))
            for name, node in snapshot.nodes.items()
        }
        return result.placed, geoms

    placed1, geoms1 = run(1)
    placed2, geoms2 = run(99)
    assert placed1 == placed2
    assert geoms1 == geoms2


# -- test_cluster_state.py ----------------------------------------------------
def tpu_cluster_node(pk, name="n1", topo="4x4"):
    return pk.Node(
        metadata=pk.ObjectMeta(
            name=name,
            labels={
                pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU,
                pk.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                pk.constants.LABEL_TPU_TOPOLOGY: topo,
            },
        ),
        status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64, "google.com/tpu": 16})),
    )


def running_pod(pk, name, node, resources, ns="default"):
    p = pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns),
        spec=pk.PodSpec(containers=[pk.Container(resources=pk.ResourceList.of(resources))]),
    )
    p.spec.node_name = node
    p.status.phase = pk.PodPhase.RUNNING
    return p


def test_cluster_state_mirrors_watch_events(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)

    cluster.create(tpu_cluster_node(pk, "n1"))
    cluster.create(running_pod(pk, "p1", "n1", {"cpu": 2}))
    assert state.partitioning_enabled(pk.constants.KIND_TPU)
    assert not state.partitioning_enabled(pk.constants.KIND_MIG)
    assert [n.metadata.name for n in state.nodes()] == ["n1"]
    assert state.node_requested("n1")["cpu"] == 2

    # Pod completes -> usage drops.
    cluster.patch("Pod", "default", "p1", lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED))
    assert state.node_requested("n1") == {}

    cluster.delete("Node", "", "n1")
    assert state.nodes() == []


def test_snapshot_taker_builds_tpu_nodes_from_annotations(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)

    node = tpu_cluster_node(pk, "n1")
    node.metadata.annotations.update(
        {
            "tpu.nos/status-dev-0-2x2-free": "1",
            "tpu.nos/status-dev-0-2x2-used": "1",
        }
    )
    cluster.create(node)
    cluster.create(running_pod(pk, "p1", "n1", {"google.com/tpu-2x2": 1}))

    snap = pk.TpuSnapshotTaker().take_snapshot(state)
    tn = snap.get_node("n1")
    assert tn.mesh.geometry == {P(pk, "2x2"): 2}
    assert tn.mesh.used == {P(pk, "2x2"): 1}
    info = tn.node_info()
    assert info.allocatable["google.com/tpu-2x2"] == 2
    assert info.allocatable[pk.constants.RESOURCE_TPU] == 8  # 16 - carved 8
    assert info.requested["google.com/tpu-2x2"] == 1


def test_snapshot_fork_revert_commit(pk):
    mesh = pk.TpuMesh(pk.Topology.parse("v5e", "4x4"))
    node = pk.TpuNode("n1", mesh, base_allocatable=pk.ResourceList.of({"cpu": 8}))
    snap = pk.Snapshot({"n1": node}, pk.TpuSliceSpec())

    snap.fork()
    snap.get_node("n1").update_geometry_for({"google.com/tpu-2x2": 2})
    assert snap.get_node("n1").mesh.geometry == {P(pk, "2x2"): 2}
    snap.revert()
    assert snap.get_node("n1").mesh.geometry == {}

    snap.fork()
    snap.get_node("n1").update_geometry_for({"google.com/tpu-2x2": 1})
    snap.commit()
    assert snap.get_node("n1").mesh.geometry == {P(pk, "2x2"): 1}


def test_snapshot_lacking_slices(pk):
    mesh = pk.TpuMesh(pk.Topology.parse("v5e", "4x4"), {P(pk, "2x2"): 1})
    node = pk.TpuNode("n1", mesh, base_allocatable=pk.ResourceList.of({"cpu": 8}))
    snap = pk.Snapshot({"n1": node}, pk.TpuSliceSpec())

    pod2 = pk.Pod(
        spec=pk.PodSpec(
            containers=[pk.Container(resources=pk.ResourceList.of({"google.com/tpu-2x2": 3}))]
        ),
        metadata=pk.ObjectMeta(name="p", namespace="d"),
    )
    lacking = snap.get_lacking_slices(pod2)
    assert lacking == {"google.com/tpu-2x2": 2}  # one free already


# -- test_e2e_partitioning.py -------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_tpu_node(pk, name="tpu-node-0", topo="4x4"):
    return pk.Node(
        metadata=pk.ObjectMeta(
            name=name,
            labels={
                pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU,
                pk.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                pk.constants.LABEL_TPU_TOPOLOGY: topo,
            },
        ),
        status=pk.NodeStatus(
            allocatable=pk.ResourceList.of({"cpu": 64, "memory": "128Gi", "google.com/tpu": 16}),
            capacity=pk.ResourceList.of({"cpu": 64, "memory": "128Gi", "google.com/tpu": 16}),
        ),
    )


def unschedulable_slice_pod(pk, name, profile="2x2", ns="ml"):
    p = pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns),
        spec=pk.PodSpec(
            containers=[
                pk.Container(
                    resources=pk.ResourceList.of(
                        {f"google.com/tpu-{profile}": 1, "cpu": "500m"}
                    )
                )
            ],
            scheduler_name=pk.constants.SCHEDULER_NAME,
        ),
    )
    p.status.phase = pk.PodPhase.PENDING
    p.status.conditions.append(
        pk.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
    )
    return p


def bind_if_fits(pk, cluster, state, pod):
    """Minimal stand-in for the scheduler's bind step (M5 brings the real one):
    bind the pod to the first TPU node whose refreshed allocatable fits it."""
    taker = pk.TpuSnapshotTaker()
    snap = taker.take_snapshot(state)
    sim = pk.FitSimScheduler()
    for name in sorted(snap.nodes):
        info = snap.get_node(name).node_info()
        if sim.filter(pod, info):
            def bind(p):
                p.spec.node_name = name
                p.status.phase = pk.PodPhase.RUNNING
                p.status.conditions = []
            cluster.patch("Pod", pod.metadata.namespace, pod.metadata.name, bind)
            return name
    return None


@pytest.fixture
def env(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    node = make_tpu_node(pk)
    cluster.create(node)

    client = pk.FakeTpuClient(pk.Topology.parse("v5e", "4x4"))
    agent = pk.TpuAgent(cluster, "tpu-node-0", client)
    agent.startup()
    agent.start_watching()

    controller = pk.PartitionerController(
        cluster=cluster,
        state=state,
        kind=pk.constants.KIND_TPU,
        snapshot_taker=pk.TpuSnapshotTaker(),
        partitioner=pk.TpuPartitioner(cluster),
        sim_scheduler=pk.FitSimScheduler(),
        batch_timeout_s=60,
        batch_idle_s=10,
        now=clock,
    )
    controller.start_watching()
    return cluster, state, clock, client, agent, controller


def test_end_to_end_single_pod(pk, env):
    cluster, state, clock, client, agent, controller = env

    pod = unschedulable_slice_pod(pk, "jax-job-0")
    cluster.create(pod)
    assert len(controller.batcher) == 1

    # Batch not closed yet -> no planning.
    assert not controller.process_batch_if_ready()
    clock.advance(11)  # idle window passes
    assert controller.process_batch_if_ready()

    # Spec annotations landed and the agent (watch-driven) applied + reported.
    node = cluster.get("Node", "", "tpu-node-0")
    assert node.metadata.annotations.get("tpu.nos/spec-dev-0-2x2") == "1"
    specs = pk.ann.parse_spec(node.metadata.annotations)
    statuses = pk.ann.parse_status(node.metadata.annotations)
    assert pk.ann.spec_matches_status(specs, statuses)
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    # Device layer really carved the slice.
    assert [s.profile.name for s in client.list_slices()] == ["2x2"]
    # Allocatable was refreshed: 4 chips carved out of 16.
    assert node.status.allocatable["google.com/tpu-2x2"] == 1
    assert node.status.allocatable[pk.constants.RESOURCE_TPU] == 12

    # The pod now fits and binds.
    bound = bind_if_fits(pk, cluster, state, cluster.get("Pod", "ml", "jax-job-0"))
    assert bound == "tpu-node-0"

    # Agent usage sync marks the slice used on next report.
    agent.report()
    node = cluster.get("Node", "", "tpu-node-0")
    assert node.metadata.annotations["tpu.nos/status-dev-0-2x2-used"] == "1"
    assert node.metadata.annotations["tpu.nos/status-dev-0-2x2-free"] == "0"


def test_end_to_end_second_cycle_respects_used_slices(pk, env):
    cluster, state, clock, client, agent, controller = env

    # Cycle 1: place a 2x2 pod and bind it.
    cluster.create(unschedulable_slice_pod(pk, "jax-a"))
    clock.advance(11)
    assert controller.process_batch_if_ready()
    assert bind_if_fits(pk, cluster, state, cluster.get("Pod", "ml", "jax-a"))
    agent.report()

    # Cycle 2: a 2x4 pod arrives; re-carve must keep the used 2x2.
    cluster.create(unschedulable_slice_pod(pk, "jax-b", profile="2x4"))
    clock.advance(11)
    assert controller.process_batch_if_ready()

    node = cluster.get("Node", "", "tpu-node-0")
    assert node.metadata.annotations.get("tpu.nos/spec-dev-0-2x2") == "1"
    assert node.metadata.annotations.get("tpu.nos/spec-dev-0-2x4") == "1"
    profiles = sorted(s.profile.name for s in client.list_slices())
    assert profiles == ["2x2", "2x4"]
    # The used 2x2 slice survived (same id).
    used = [s for s in client.list_slices() if s.in_use]
    assert len(used) == 1 and used[0].profile.name == "2x2"

    assert bind_if_fits(pk, cluster, state, cluster.get("Pod", "ml", "jax-b"))


def test_handshake_blocks_replanning_until_agent_reports(pk, env):
    cluster, state, clock, client, agent, controller = env
    agent.stop()  # simulate a dead agent: spec will go unreported

    cluster.create(unschedulable_slice_pod(pk, "jax-a"))
    clock.advance(11)
    assert controller.process_batch_if_ready()  # plans; spec written, no report

    node = cluster.get("Node", "", "tpu-node-0")
    assert not pk.ann.node_reported_last_plan(node.metadata.annotations)

    # New pod arrives; planner must refuse to plan while the node lags.
    cluster.create(unschedulable_slice_pod(pk, "jax-b"))
    clock.advance(61)
    assert not controller.process_batch_if_ready()
    assert controller.waiting_for_plan_reports() == ["tpu-node-0"]

    # Agent comes back, catches up, reports -> planning unblocks.
    agent.reconcile()
    assert controller.waiting_for_plan_reports() == []
    clock.advance(61)
    assert controller.process_batch_if_ready()


def test_agent_partial_apply_on_device_failure(pk, env):
    cluster, state, clock, client, agent, controller = env
    client.fail_next = 1  # first create_slice will fail

    cluster.create(unschedulable_slice_pod(pk, "jax-a"))
    clock.advance(11)
    controller.process_batch_if_ready()

    node = cluster.get("Node", "", "tpu-node-0")
    # Apply failed, but the agent still reported actual (empty) state and the
    # plan id -> the handshake completes and status shows no slices.
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    assert client.list_slices() == []
    # Next reconcile succeeds (controller would requeue; we re-trigger).
    agent.reconcile()
    assert [s.profile.name for s in client.list_slices()] == ["2x2"]


# -- test_gpu_modes.py --------------------------------------------------------
A100_40 = "NVIDIA-A100-PCIE-40GB"


def MP(pk, name):
    return pk.MigProfile.parse(name)


def MS(pk, name):
    return pk.MpsProfile.parse(name)


# -- MIG domain model --------------------------------------------------------
def test_mig_profile_parse_and_order(pk):
    p = pk.MigProfile.parse("nvidia.com/mig-1g.10gb")
    assert p.gi == 1 and p.memory_gb == 10 and p.resource == "nvidia.com/mig-1g.10gb"
    assert sorted([MP(pk, "7g.40gb"), MP(pk, "1g.5gb"), MP(pk, "2g.10gb")]) == [
        MP(pk, "1g.5gb"),
        MP(pk, "2g.10gb"),
        MP(pk, "7g.40gb"),
    ]


def test_mig_geometry_allowed_a100_40(pk):
    assert pk.geometry_allowed(A100_40, {MP(pk, "1g.5gb"): 7})
    assert pk.geometry_allowed(A100_40, {MP(pk, "3g.20gb"): 2})
    assert pk.geometry_allowed(A100_40, {MP(pk, "2g.10gb"): 3, MP(pk, "1g.5gb"): 1})
    assert not pk.geometry_allowed(A100_40, {MP(pk, "1g.5gb"): 8})  # > 7 compute slots
    # 2x 3g.20gb + 1g.5gb = 45GB > 40GB memory budget.
    assert not pk.geometry_allowed(A100_40, {MP(pk, "3g.20gb"): 2, MP(pk, "1g.5gb"): 1})
    assert not pk.geometry_allowed(A100_40, {MP(pk, "7g.40gb"): 1, MP(pk, "1g.5gb"): 1})
    assert not pk.geometry_allowed(A100_40, {MP(pk, "1g.6gb"): 1})  # A30 profile
    assert not pk.geometry_allowed("unknown-model", {MP(pk, "1g.5gb"): 1})


def test_mig_geometry_override(pk):
    pk.set_known_geometries(A100_40, [{"1g.5gb": 2}])
    try:
        assert pk.geometry_allowed(A100_40, {MP(pk, "1g.5gb"): 2})
        assert not pk.geometry_allowed(A100_40, {MP(pk, "1g.5gb"): 7})
    finally:
        pk.clear_known_geometry_overrides()


def test_mig_gpu_update_geometry_never_deletes_used(pk):
    gpu = pk.MigGpu(A100_40, 0, {MP(pk, "7g.40gb"): 1}, used={MP(pk, "7g.40gb"): 1})
    assert not gpu.update_geometry_for({MP(pk, "1g.5gb"): 1})  # full with used slice
    gpu2 = pk.MigGpu(A100_40, 0, {MP(pk, "1g.5gb"): 2}, used={MP(pk, "1g.5gb"): 1})
    assert gpu2.update_geometry_for({MP(pk, "3g.20gb"): 2})
    assert gpu2.geometry[MP(pk, "1g.5gb")] >= 1  # the used slice survived
    # Memory budget (40GB) fits only one 3g.20gb next to the used 1g.5gb.
    assert gpu2.geometry[MP(pk, "3g.20gb")] == 1


# -- MPS domain model --------------------------------------------------------
def test_mps_profile_and_budget(pk):
    assert MS(pk, "10gb").memory_gb == 10
    assert MS(pk, "nvidia.com/gpu-5gb").resource == "nvidia.com/gpu-5gb"
    with pytest.raises(ValueError):
        pk.MpsProfile.parse("0gb")
    gpu = pk.MpsGpu(40, 0, {MS(pk, "10gb"): 3})
    assert gpu.free_gb == 10
    assert gpu.can_apply_geometry({MS(pk, "20gb"): 2})
    assert not gpu.can_apply_geometry({MS(pk, "20gb"): 3})  # 60 > 40


def test_mps_gpu_freeform_carve(pk):
    gpu = pk.MpsGpu(40, 0, {MS(pk, "10gb"): 2}, used={MS(pk, "10gb"): 1})
    assert gpu.update_geometry_for({MS(pk, "20gb"): 1})
    # Used 10gb survives; 20gb carved; leftover refilled with the free 10gb.
    assert gpu.geometry[MS(pk, "10gb")] == 2 and gpu.geometry[MS(pk, "20gb")] == 1


# -- planner on simulated A100 nodes (BASELINE configs[1]) -------------------
def mig_node(pk, cluster, name="gpu-node-0", gpus=1, model=A100_40):
    node = pk.Node(
        metadata=pk.ObjectMeta(
            name=name,
            labels={
                pk.constants.LABEL_PARTITIONING: pk.constants.KIND_MIG,
                pk.constants.LABEL_GPU_PRODUCT: model,
                pk.constants.LABEL_GPU_COUNT: str(gpus),
                pk.constants.LABEL_GPU_MEMORY: "40536",
            },
        ),
        status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64, "memory": "256Gi"})),
    )
    cluster.create(node)
    return node


def unschedulable_pod(pk, name, resources, ns="default"):
    p = pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns),
        spec=pk.PodSpec(containers=[pk.Container(resources=pk.ResourceList.of(resources))]),
    )
    p.status.phase = pk.PodPhase.PENDING
    p.status.conditions.append(
        pk.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
    )
    return p


def make_controller(pk, cluster, state, kind, taker, partitioner, clock):
    c = pk.PartitionerController(
        cluster=cluster,
        state=state,
        kind=kind,
        snapshot_taker=taker,
        partitioner=partitioner,
        sim_scheduler=pk.FitSimScheduler(),
        now=clock,
    )
    c.start_watching()
    return c


def test_mig_end_to_end_with_agent(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    mig_node(pk, cluster, gpus=2)

    client = pk.FakeGpuDeviceClient(2, pk.mig_validator(A100_40))
    agent = pk.GpuAgent(cluster, "gpu-node-0", client)
    agent.startup()
    agent.start_watching()

    controller = make_controller(pk, 
        cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(), pk.MigPartitioner(cluster), clock
    )

    cluster.create(unschedulable_pod(pk, "train-a", {"nvidia.com/mig-3g.20gb": 1}))
    cluster.create(unschedulable_pod(pk, "train-b", {"nvidia.com/mig-1g.5gb": 2}))
    clock.advance(11)
    assert controller.process_batch_if_ready()

    node = cluster.get("Node", "", "gpu-node-0")
    specs = pk.ann.parse_spec(node.metadata.annotations)
    assert specs, "planner wrote MIG spec annotations"
    statuses = pk.ann.parse_status(node.metadata.annotations)
    assert pk.ann.spec_matches_status(specs, statuses)
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    # Devices actually exist and allocatable exposes them.
    profiles = sorted(d.profile for d in client.list_devices())
    assert "3g.20gb" in profiles and "1g.5gb" in profiles
    assert node.status.allocatable.get("nvidia.com/mig-3g.20gb", 0) >= 1
    assert node.status.allocatable.get("nvidia.com/mig-1g.5gb", 0) >= 2


def test_mig_multi_gpu_spreads_when_one_gpu_full(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    node = mig_node(pk, cluster, gpus=2)
    # GPU 0 fully used by a 7g.40gb slice.
    cluster.patch(
        "Node",
        "",
        "gpu-node-0",
        lambda n: n.metadata.annotations.update(
            {
                "tpu.nos/status-dev-0-7g.40gb-used": "1",
                "tpu.nos/status-dev-0-7g.40gb-free": "0",
            }
        ),
    )
    controller = make_controller(pk, 
        cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(), pk.MigPartitioner(cluster), clock
    )
    cluster.create(unschedulable_pod(pk, "p", {"nvidia.com/mig-7g.40gb": 1}))
    clock.advance(11)
    assert controller.process_batch_if_ready()
    node = cluster.get("Node", "", "gpu-node-0")
    specs = pk.ann.parse_spec(node.metadata.annotations)
    by_gpu = pk.ann.geometry_counts_from_spec(specs)
    assert by_gpu[0] == {"7g.40gb": 1}  # kept (used)
    assert by_gpu[1] == {"7g.40gb": 1}  # carved on the second GPU


def test_mps_end_to_end_configmap_and_label(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    node = pk.Node(
        metadata=pk.ObjectMeta(
            name="mps-node-0",
            labels={
                pk.constants.LABEL_PARTITIONING: pk.constants.KIND_MPS,
                pk.constants.LABEL_GPU_PRODUCT: "NVIDIA-A100-PCIE-40GB",
                pk.constants.LABEL_GPU_COUNT: "1",
                pk.constants.LABEL_GPU_MEMORY: "40536",
            },
        ),
        status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64})),
    )
    cluster.create(node)

    client = pk.FakeGpuDeviceClient(1, pk.mps_validator(40))
    agent = pk.GpuAgent(
        cluster,
        "mps-node-0",
        client,
        parse_profile=pk.MpsProfile.from_resource,
        resource_of=lambda p: f"nvidia.com/gpu-{p}",
    )
    agent.startup()
    agent.start_watching()

    controller = make_controller(pk, 
        cluster, state, pk.constants.KIND_MPS, pk.MpsSnapshotTaker(), pk.MpsPartitioner(cluster), clock
    )
    cluster.create(unschedulable_pod(pk, "infer-1", {"nvidia.com/gpu-10gb": 1}))
    cluster.create(unschedulable_pod(pk, "infer-2", {"nvidia.com/gpu-10gb": 1}))
    clock.advance(11)
    assert controller.process_batch_if_ready()

    node = cluster.get("Node", "", "mps-node-0")
    # Device-plugin ConfigMap rewritten and node label flipped (mps channel).
    config_key = node.metadata.labels[pk.constants.LABEL_DEVICE_PLUGIN_CONFIG]
    cm = cluster.get(
        "ConfigMap",
        pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE,
        pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAME,
    )
    config = json.loads(cm.data[config_key])
    mps_resources = config["sharing"]["mps"]["resources"]
    assert any(r["memoryGB"] == 10 and r["replicas"] >= 2 for r in mps_resources)
    # Handshake completed by the agent and allocatable refreshed.
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    assert node.status.allocatable.get("nvidia.com/gpu-10gb", 0) >= 2


def test_hybrid_node_serves_mig_and_mps_across_two_plans(pk):
    """A node labeled `hybrid` (constants.KIND_HYBRID; reference
    pkg/gpu/partitioning.go:75) is eligible for BOTH modes: the MIG
    controller carves a mig profile on one GPU (plan 1), then the MPS
    controller slices ANOTHER GPU (plan 2) WITHOUT wiping the MIG plan —
    the two spec sets coexist on the node, one agent actuates both, and
    each GPU stays single-mode (MIG is a per-GPU hardware mode)."""

    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    cluster.create(
        pk.Node(
            metadata=pk.ObjectMeta(
                name="hy-node-0",
                labels={
                    pk.constants.LABEL_PARTITIONING: pk.constants.KIND_HYBRID,
                    pk.constants.LABEL_GPU_PRODUCT: A100_40,
                    pk.constants.LABEL_GPU_COUNT: "2",
                    pk.constants.LABEL_GPU_MEMORY: "40536",
                },
            ),
            status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64})),
        )
    )
    assert state.partitioning_enabled(pk.constants.KIND_MIG)
    assert state.partitioning_enabled(pk.constants.KIND_MPS)

    client = pk.FakeGpuDeviceClient(2, pk.hybrid_validator(A100_40, 40))
    agent = pk.GpuAgent(
        cluster,
        "hy-node-0",
        client,
        parse_profile=pk.hybrid_parse_profile,
        resource_of=pk.hybrid_resource_of,
    )
    agent.startup()
    agent.start_watching()

    mig_ctrl = make_controller(pk, 
        cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(), pk.MigPartitioner(cluster), clock
    )
    mps_ctrl = make_controller(pk, 
        cluster, state, pk.constants.KIND_MPS, pk.MpsSnapshotTaker(), pk.MpsPartitioner(cluster), clock
    )

    # Plan 1: the MIG controller carves for a mig-profile pod.
    cluster.create(unschedulable_pod(pk, "train", {"nvidia.com/mig-3g.20gb": 1}))
    clock.advance(11)
    assert mig_ctrl.process_batch_if_ready()
    node = cluster.get("Node", "", "hy-node-0")
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    assert node.status.allocatable.get("nvidia.com/mig-3g.20gb", 0) >= 1

    # Plan 2: the MPS controller adds a slice for an mps pod.
    cluster.create(unschedulable_pod(pk, "infer", {"nvidia.com/gpu-10gb": 1}))
    clock.advance(11)
    assert mps_ctrl.process_batch_if_ready()

    node = cluster.get("Node", "", "hy-node-0")
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    # Both modes' spec annotations coexist (the MPS rewrite did not strip
    # the MIG plan) and both device sets are live on the one node.
    spec_profiles = {s.profile for s in pk.ann.parse_spec(node.metadata.annotations)}
    assert "3g.20gb" in spec_profiles and "10gb" in spec_profiles
    # Each GPU is single-mode: the MIG carve and the MPS slice landed on
    # DIFFERENT GPUs of the hybrid node.
    by_gpu = {}
    for d in client.list_devices():
        by_gpu.setdefault(d.gpu_index, set()).add(d.profile)
    mig_gpus = {gi for gi, profs in by_gpu.items() if "3g.20gb" in profs}
    mps_gpus = {gi for gi, profs in by_gpu.items() if "10gb" in profs}
    assert mig_gpus and mps_gpus and mig_gpus.isdisjoint(mps_gpus)
    assert node.status.allocatable.get("nvidia.com/mig-3g.20gb", 0) >= 1
    assert node.status.allocatable.get("nvidia.com/gpu-10gb", 0) >= 1
    statuses = pk.ann.parse_status(node.metadata.annotations)
    assert pk.ann.spec_matches_status(
        pk.ann.parse_spec(node.metadata.annotations), statuses
    )


def test_hybrid_validator_single_mode_per_gpu(pk):
    """Each GPU of a hybrid node is either MIG-partitioned or MPS-sliced —
    never both (MIG is a per-GPU hardware mode); single-mode geometries
    follow that mode's own rules."""

    v = pk.hybrid_validator(A100_40, 40)
    assert v(0, {"3g.20gb": 2})  # valid MIG menu row
    assert v(0, {"10gb": 4})  # 40 GB of MPS slices: fits
    assert not v(0, {"3g.20gb": 1, "10gb": 1})  # mixed modes on one GPU
    assert not v(0, {"10gb": 5})  # MPS over budget
    assert not v(0, {"3g.20gb": 3})  # not a feasible MIG geometry
    assert not v(0, {"bogus": 1})


def test_device_plugin_restart_after_geometry_change(pk):

    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    mig_node(pk, cluster, gpus=1)

    ds = pk.FakeDevicePluginDaemonSet(cluster).start()
    ds.ensure_pod("gpu-node-0")
    old_pod = cluster.list(
        "Pod", namespace=pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE
    )[0]

    client = pk.FakeGpuDeviceClient(1, pk.mig_validator(A100_40))
    agent = pk.GpuAgent(
        cluster, "gpu-node-0", client, plugin_client=pk.DevicePluginClient(cluster)
    )
    agent.startup()
    agent.start_watching()
    controller = make_controller(pk, 
        cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(), pk.MigPartitioner(cluster), clock
    )
    cluster.create(unschedulable_pod(pk, "p", {"nvidia.com/mig-1g.5gb": 1}))
    clock.advance(11)
    assert controller.process_batch_if_ready()

    # Geometry changed -> the plugin pod was deleted and a replacement
    # (new uid) recreated by the DaemonSet simulator, already Running.
    pods = cluster.list("Pod", namespace=pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE)
    assert len(pods) == 1
    assert pods[0].metadata.uid != old_pod.metadata.uid
    assert pods[0].status.phase == pk.PodPhase.RUNNING

    # Without a DaemonSet recreating the pod, restart times out.
    ds.stop()
    fake_time = {"t": 0.0}
    restarter = pk.DevicePluginClient(
        cluster,
        timeout_s=1.0,
        now=lambda: fake_time["t"],
        sleep=lambda dt: fake_time.__setitem__("t", fake_time["t"] + dt),
    )
    with pytest.raises(pk.RestartTimeoutError):
        restarter.restart("gpu-node-0")


def test_permutation_search_handles_order_sensitive_creation(pk):
    """Placement-constrained device creation (MIG's NVML behavior): this fake
    rejects creating a profile larger than any profile already present on the
    GPU, so a mixed geometry only applies big-to-small. The agent's bounded
    permutation search (nvml/client.go:225-340 analog) must find that order;
    naive sorted-ascending creation would partial-fail."""

    class OrderSensitiveClient(pk.FakeGpuDeviceClient):
        def create_device(self, gpu_index, profile):
            size = pk.MigProfile.parse(profile).gi
            existing = [
                pk.MigProfile.parse(d.profile).gi
                for d in self.list_devices()
                if d.gpu_index == gpu_index
            ]
            if existing and size > min(existing):

                raise pk.TpuLibError(f"fragmented: cannot place {profile}")
            return super().create_device(gpu_index, profile)

    cluster = pk.Cluster()
    mig_node(pk, cluster, gpus=1)
    client = OrderSensitiveClient(1, pk.mig_validator(A100_40))
    agent = pk.GpuAgent(cluster, "gpu-node-0", client)
    agent.startup()

    # Desired: 1x 3g.20gb + 3x 1g.5gb. Ascending creation order would fail
    # at the 3g.20gb; the search must land on descending.
    agent._apply_changed = False
    agent._apply({(0, "1g.5gb"): 3, (0, "3g.20gb"): 1})
    assert agent._apply_changed
    profiles = sorted(d.profile for d in client.list_devices())
    assert profiles == ["1g.5gb", "1g.5gb", "1g.5gb", "3g.20gb"]

    # Re-carving 3g.20gb -> 2g.10gb recreates the free 1g survivors so the
    # permutation space includes them (plan/plan.go:94-109): the 2g must be
    # placed before the recreated 1gs, which only the search discovers.
    agent._apply_changed = False
    agent._apply({(0, "1g.5gb"): 3, (0, "2g.10gb"): 1})
    assert agent._apply_changed
    profiles = sorted(d.profile for d in client.list_devices())
    assert profiles == ["1g.5gb", "1g.5gb", "1g.5gb", "2g.10gb"]


# -- known-geometry table parity (known_configs.go:25-142) --------------------
def test_default_known_geometries_match_reference_tables(pk):
    """The default menus must equal the reference's published tables EXACTLY
    (including upstream's idiosyncratic 80GB rows): the planner admits only
    menu geometries, so any divergence changes planning behavior."""

    def menu(model):
        table = pk.allowed_geometries(model)
        assert table is not None, model
        return sorted(
            tuple(sorted((p.name, n) for p, n in g.items())) for g in table
        )

    assert menu("A30") == sorted(
        [
            (("4g.24gb", 1),),
            (("2g.12gb", 2),),
            (("1g.6gb", 2), ("2g.12gb", 1)),
            (("1g.6gb", 4),),
        ]
    )
    a100_40 = sorted(
        [
            (("7g.40gb", 1),),
            (("1g.5gb", 1), ("2g.10gb", 1), ("4g.20gb", 1)),
            (("1g.5gb", 3), ("4g.20gb", 1)),
            (("3g.20gb", 2),),
            (("1g.5gb", 1), ("2g.10gb", 1), ("3g.20gb", 1)),
            (("1g.5gb", 3), ("3g.20gb", 1)),
            (("2g.10gb", 2), ("3g.20gb", 1)),
            (("1g.5gb", 2), ("2g.10gb", 1), ("3g.20gb", 1)),
            (("1g.5gb", 1), ("2g.10gb", 3)),
            (("1g.5gb", 3), ("2g.10gb", 2)),
            (("1g.5gb", 5), ("2g.10gb", 1)),
            (("1g.5gb", 7),),
        ]
    )
    assert menu("NVIDIA-A100-40GB-SXM4") == a100_40
    # GFD product-label spellings resolve to the same menu.
    assert menu(A100_40) == a100_40
    assert menu("NVIDIA-A100-80GB-PCIe") == sorted(
        [
            (("7g.79gb", 1),),
            (("1g.10gb", 1), ("2g.20gb", 1), ("4g.40gb", 1)),
            (("1g.10gb", 3), ("4g.40gb", 1)),
            (("3g.40gb", 2),),
            (("1g.10gb", 1), ("2g.20gb", 1), ("3g.40gb", 1)),
            (("1g.10gb", 3), ("3g.40gb", 1)),
            (("2g.20gb", 2), ("3g.20gb", 1)),
            (("1g.10gb", 2), ("2g.10gb", 1), ("3g.40gb", 1)),
            (("1g.10gb", 1), ("2g.20gb", 3)),
            (("1g.10gb", 3), ("2g.20gb", 2)),
            (("1g.10gb", 5), ("2g.20gb", 1)),
            (("1g.10gb", 7),),
        ]
    )


def test_menu_update_geometry_picks_most_providing_candidate(pk):
    """Menu-driven UpdateGeometryFor (gpu.go:141-193): the chosen geometry is
    the one providing the most missing required profiles, applied whole."""
    gpu = pk.MigGpu(A100_40, 0)
    assert gpu.update_geometry_for({MP(pk, "1g.5gb"): 4})
    # Several menu entries provide all 4 (a tie the reference breaks by map
    # order); what matters is the requirement is fully provided and the
    # geometry is a menu entry.
    assert gpu.geometry.get(MP(pk, "1g.5gb"), 0) >= 4
    assert pk.geometry_allowed(A100_40, gpu.geometry)
    # With a used slice pinned, only candidates containing it qualify.
    gpu2 = pk.MigGpu(A100_40, 0, {MP(pk, "3g.20gb"): 1}, used={MP(pk, "3g.20gb"): 1})
    assert gpu2.update_geometry_for({MP(pk, "2g.10gb"): 2})
    assert gpu2.geometry == {MP(pk, "2g.10gb"): 2, MP(pk, "3g.20gb"): 1}


def test_menu_update_noop_when_best_row_is_current_carve(pk):
    """When the best admissible menu row IS the current geometry, the update
    reports no change — returning True here made the planner re-simulate an
    unchanged node every cycle instead of pruning the candidate."""
    gpu = pk.MigGpu(A100_40, 0, {MP(pk, "1g.5gb"): 7}, used={MP(pk, "1g.5gb"): 5})
    # Demand exceeds what any row containing the 5 used slices can add:
    # {1g.5gb:7} is the only admissible row and it's already applied.
    assert not gpu.update_geometry_for({MP(pk, "1g.5gb"): 9})
    assert gpu.geometry == {MP(pk, "1g.5gb"): 7}


def test_menu_update_does_not_destroy_required_free_devices(pk):
    """Scoring accounts for the fact that applying a menu row REPLACES the
    geometry: a row that provides one missing profile by destroying free
    devices of another required profile must lose to a row providing both."""
    gpu = pk.MigGpu(A100_40, 0, {MP(pk, "1g.5gb"): 7})
    assert gpu.update_geometry_for({MP(pk, "1g.5gb"): 2, MP(pk, "3g.20gb"): 1})
    assert gpu.geometry.get(MP(pk, "1g.5gb"), 0) >= 2
    assert gpu.geometry.get(MP(pk, "3g.20gb"), 0) >= 1
    assert pk.geometry_allowed(A100_40, gpu.geometry)


def test_geometry_override_honored_under_alias(pk):
    """An override keyed by the canonical table name must apply to nodes
    whose GFD label is an alias spelling (and vice versa)."""
    pk.set_known_geometries("A30", [{"1g.6gb": 1}])
    try:
        assert pk.geometry_allowed("NVIDIA-A30", {MP(pk, "1g.6gb"): 1})
        assert not pk.geometry_allowed("NVIDIA-A30", {MP(pk, "1g.6gb"): 4})
    finally:
        pk.clear_known_geometry_overrides()
    pk.set_known_geometries("NVIDIA-A100-PCIE-40GB", [{"1g.5gb": 2}])
    try:
        assert not pk.geometry_allowed("NVIDIA-A100-PCIE-40GB", {MP(pk, "1g.5gb"): 7})
    finally:
        pk.clear_known_geometry_overrides()


def test_geometry_feasible_accepts_partial_states(pk):

    # {1g.5gb: 2} is not a menu entry but is a sub-multiset of {1g.5gb: 7}.
    assert pk.geometry_feasible(A100_40, {MP(pk, "1g.5gb"): 2})
    assert not pk.geometry_allowed(A100_40, {MP(pk, "1g.5gb"): 2})
    # 8x 1g.5gb exceeds every menu entry.
    assert not pk.geometry_feasible(A100_40, {MP(pk, "1g.5gb"): 8})


def test_spec_menus_agree_with_tables(pk):
    """Every profile a model's fallback spec menu advertises must appear in
    that model's geometry table (a menu/table disagreement makes requests
    parse as known but never carvable — e.g. 7g.80gb vs NVML's 7g.79gb)."""

    for model, spec in pk.KNOWN_MIG_MODELS.items():
        table = pk.allowed_geometries(model)
        if table is None:
            continue
        in_tables = {p for g in table for p in g}
        for p in spec.menu():
            assert p in in_tables, f"{model}: {p.name} not carvable by any table entry"


def test_infeasible_node_geometry_skipped_not_fatal(pk):
    """A node whose status annotations report a geometry the current menus
    consider impossible is skipped with a log — planning continues for the
    healthy nodes."""
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    mig_node(pk, cluster, name="stale")
    mig_node(pk, cluster, name="healthy")
    # 8x 1g.5gb exceeds every A100-40 menu row -> infeasible status.
    cluster.patch(
        "Node",
        "",
        "stale",
        lambda n: n.metadata.annotations.update(
            {"tpu.nos/status-dev-0-1g.5gb-free": "8"}
        ),
    )
    snap = pk.MigSnapshotTaker().take_snapshot(state)
    names = {n.name for n in snap.get_candidate_nodes()}
    assert "healthy" in names
    assert "stale" not in names


def test_hybrid_same_window_contention_tie_break(pk):
    """When the MIG and MPS planners claim the same uncarved GPU of a hybrid
    node within ONE batch window, neither snapshot sees the other's spec yet
    — the tie-break is that the FIRST plan to land owns the GPU and the
    second writer DROPS the contended index (deterministic convergence, no
    reject/replan churn), while its claims on other GPUs still land."""

    cluster = pk.Cluster()
    cluster.create(
        pk.Node(
            metadata=pk.ObjectMeta(
                name="hy-0",
                labels={
                    pk.constants.LABEL_PARTITIONING: pk.constants.KIND_HYBRID,
                    pk.constants.LABEL_GPU_PRODUCT: A100_40,
                    pk.constants.LABEL_GPU_COUNT: "2",
                },
            ),
            status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64})),
        )
    )
    # MIG lands first, claiming GPU 0.
    pk.MigPartitioner(cluster).apply_partitioning("hy-0", "plan-a", {0: {"3g.20gb": 2}})
    node = cluster.get("Node", "", "hy-0")
    mig_specs = pk.ann.parse_spec(node.metadata.annotations)
    assert {s.device_index for s in mig_specs if s.quantity > 0} == {0}
    # The MPS writer (same window, stale snapshot) claims GPU 0 AND GPU 1:
    # the contended index 0 is dropped, GPU 1 lands.
    contended = pk.hybrid_contended_indexes(
        node, pk._parses_as(lambda n: pk.MigProfile.parse(n))
    )
    assert contended == set()  # MIG's own filter sees its own profiles
    pk.MpsPartitioner(cluster).apply_partitioning(
        "hy-0", "plan-b", {0: {"10gb": 4}, 1: {"10gb": 4}}
    )
    node = cluster.get("Node", "", "hy-0")
    specs = pk.ann.parse_spec(node.metadata.annotations)
    by_index = {}
    for s in specs:
        if s.quantity > 0:
            by_index.setdefault(s.device_index, set()).add(s.profile)
    assert by_index[0] == {"3g.20gb"}, "first writer keeps the contended GPU"
    assert by_index[1] == {"10gb"}, "second writer's uncontended claim lands"
    # And the device-plugin ConfigMap payload matches the annotations (the
    # tie-break applies to the rendered geometry too, not just the spec).
    cm = cluster.get(
        "ConfigMap",
        pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE,
        pk.constants.DEFAULT_DEVICE_PLUGIN_CM_NAME,
    )
    payload = json.loads(cm.data["hy-0-plan-b"])
    replicas = payload["sharing"]["mps"]["resources"]
    assert [r["devices"] for r in replicas] == [[1]], (
        "the rendered plugin config must exclude the contended GPU 0"
    )
    assert replicas[0]["replicas"] == 4


# -- test_perf_planner.py -----------------------------------------------------
PROFILES = ["1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x8"]
WEIGHTS = [2.0 ** -i for i in range(len(PROFILES))]


def build_single_node_env(pk, n_nodes, topo, n_pods, seed=0):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    topology = pk.Topology.parse("v5e", topo)
    for i in range(n_nodes):
        cluster.create(
            pk.Node(
                metadata=pk.ObjectMeta(
                    name=f"n{i}",
                    labels={
                        pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU,
                        pk.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                        pk.constants.LABEL_TPU_TOPOLOGY: topo,
                    },
                ),
                status=pk.NodeStatus(
                    allocatable=pk.ResourceList.of(
                        {"cpu": 64, "google.com/tpu": topology.chips}
                    )
                ),
            )
        )
        agent = pk.TpuAgent(cluster, f"n{i}", pk.FakeTpuClient(topology))
        agent.startup()
        agent.start_watching()
    controller = pk.PartitionerController(
        cluster=cluster,
        state=state,
        kind=pk.constants.KIND_TPU,
        snapshot_taker=pk.TpuSnapshotTaker(),
        partitioner=pk.TpuPartitioner(cluster),
        sim_scheduler=pk.FitSimScheduler(),
        batch_timeout_s=1,
        batch_idle_s=1,
        now=clock,
    )
    controller.start_watching()
    rng = random.Random(seed)
    for j in range(n_pods):
        prof = rng.choices(PROFILES, WEIGHTS)[0]
        p = pk.Pod(
            metadata=pk.ObjectMeta(name=f"p{j}", namespace="ml"),
            spec=pk.PodSpec(
                containers=[
                    pk.Container(
                        resources=pk.ResourceList.of({f"google.com/tpu-{prof}": 1})
                    )
                ],
                scheduler_name=pk.constants.SCHEDULER_NAME,
            ),
        )
        p.status.phase = pk.PodPhase.PENDING
        p.status.conditions.append(
            pk.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        )
        cluster.create(p)
    clock.t += 61
    return controller, clock


def timed_round(controller):
    t0 = time.perf_counter()
    ran = controller.process_batch_if_ready()
    dt = time.perf_counter() - t0
    assert ran, "the control round must actually plan"
    return dt


def test_control_round_v5e_256_as_four_hosts(pk):
    """4 x v5e-8x8 (256 chips), 100-pod backlog: one snapshot->plan->actuate
    round (including synchronous agent applies on the bus)."""
    controller, _ = build_single_node_env(pk, 4, "8x8", 100)
    dt = timed_round(controller)
    assert dt < 2.0, f"control round took {dt:.2f}s (measured median ~0.03s)"


# -- across packages ----------------------------------------------------------
REF, PORT = NAMESPACES["nos_tpu"], NAMESPACES["nos_tpu_torch"]


def without_plan_ids(pk, mapping):
    """Annotations or labels with the plan ids taken out (each plan id is
    a fresh uuid4 stamped with time.time())."""
    ids = (pk.constants.ANNOTATION_SPEC_PLAN, pk.constants.ANNOTATION_STATUS_PLAN,
           pk.constants.LABEL_DEVICE_PLUGIN_CONFIG)
    return {k: v for k, v in mapping.items() if k not in ids}


def node_outcome(pk, cluster):
    """Per node: annotations and labels without plan ids, allocatable; and
    that each node's agent reported the plan it was given."""
    out = {}
    for node in cluster.list("Node"):
        anns = node.metadata.annotations
        assert pk.ann.node_reported_last_plan(anns), node.metadata.name
        out[node.metadata.name] = (without_plan_ids(pk, anns),
                                   without_plan_ids(pk, node.metadata.labels),
                                   dict(node.status.allocatable))
    return out


def schedulable(pk, taker, state, pods):
    """The pods that fit the carved cluster, bound greedily in name order
    onto a fresh snapshot (first node by name whose free resources hold
    the pod). chip_smoke.py's `_fit_greedily` applies the same rule on
    the card's machine."""
    snap = taker.take_snapshot(state)
    sim = pk.FitSimScheduler()
    fits = set()
    for pod in sorted(pods, key=lambda p: p.metadata.namespaced_name):
        for name in sorted(snap.nodes):
            node = snap.get_node(name)
            if sim.filter(pod, node.node_info()):
                node.add_pod(pod)
                fits.add(pod.metadata.namespaced_name)
                break
    return fits


def backlog_round(pk, n_nodes, topo):
    controller, _ = build_single_node_env(pk, n_nodes, topo, 100)
    assert controller.process_batch_if_ready()
    cluster = controller.cluster
    pods = cluster.list("Pod")
    return node_outcome(pk, cluster), schedulable(pk, pk.TpuSnapshotTaker(), controller.state, pods)


@pytest.mark.parametrize("n_nodes,topo", [(4, "8x8"), (1, "16x16")])
def test_backlog_round_equal_across_packages(n_nodes, topo):
    """test_perf_planner.py's 100-pod backlog (seed 0) after one control
    round: the same spec and status annotations per node, the same
    allocatable, and the same pods made schedulable."""
    for ns in NAMESPACES.values():
        reset(ns)
    ref_nodes, ref_fits = backlog_round(REF, n_nodes, topo)
    port_nodes, port_fits = backlog_round(PORT, n_nodes, topo)
    assert port_nodes == ref_nodes
    assert port_fits == ref_fits
    assert 0 < len(ref_fits) < 100
    spec_keys = [k for anns, _, _ in ref_nodes.values() for k in anns if "/spec-dev-" in k]
    assert spec_keys, "the round carved nothing"


GPU_BACKLOG = ["nvidia.com/mig-1g.5gb", "nvidia.com/mig-2g.10gb", "nvidia.com/mig-3g.20gb",
               "nvidia.com/gpu-10gb", "nvidia.com/gpu-20gb"]


def gpu_modes_round(pk, seed=0, n_pods=12):
    """An MPS node (one 40 GB GPU) and a MIG node (two A100-SXM4-40GB),
    each with its agent, a MIG and an MPS controller, and a seeded backlog
    of both modes' pods; one round of each controller."""
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    mig_node(pk, cluster, name="mig-0", gpus=2, model="NVIDIA-A100-SXM4-40GB")
    cluster.create(pk.Node(
        metadata=pk.ObjectMeta(name="mps-0", labels={
            pk.constants.LABEL_PARTITIONING: pk.constants.KIND_MPS,
            pk.constants.LABEL_GPU_PRODUCT: "NVIDIA-A100-PCIE-40GB",
            pk.constants.LABEL_GPU_COUNT: "1",
            pk.constants.LABEL_GPU_MEMORY: "40536",
        }),
        status=pk.NodeStatus(allocatable=pk.ResourceList.of({"cpu": 64})),
    ))
    mig_client = pk.FakeGpuDeviceClient(2, pk.mig_validator("NVIDIA-A100-SXM4-40GB"))
    mps_client = pk.FakeGpuDeviceClient(1, pk.mps_validator(40))
    agents = [
        pk.GpuAgent(cluster, "mig-0", mig_client),
        pk.GpuAgent(cluster, "mps-0", mps_client, parse_profile=pk.MpsProfile.from_resource,
                    resource_of=lambda p: f"nvidia.com/gpu-{p}"),
    ]
    for agent in agents:
        agent.startup()
        agent.start_watching()
    mig_ctrl = make_controller(pk, cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(),
                               pk.MigPartitioner(cluster), clock)
    mps_ctrl = make_controller(pk, cluster, state, pk.constants.KIND_MPS, pk.MpsSnapshotTaker(),
                               pk.MpsPartitioner(cluster), clock)
    rng = random.Random(seed)
    for i in range(n_pods):
        cluster.create(unschedulable_pod(pk, f"job-{i}", {rng.choice(GPU_BACKLOG): 1}))
    clock.advance(11)
    assert mig_ctrl.process_batch_if_ready()
    assert mps_ctrl.process_batch_if_ready()
    devices = {name: [(d.device_id, d.gpu_index, d.profile, d.in_use) for d in c.list_devices()]
               for name, c in (("mig-0", mig_client), ("mps-0", mps_client))}
    configs = sorted(json.loads(v) for cm in cluster.list("ConfigMap") for v in cm.data.values())
    return node_outcome(pk, cluster), devices, configs


def test_mig_and_mps_nodes_equal_across_packages():
    for ns in NAMESPACES.values():
        reset(ns)
    ref = gpu_modes_round(REF)
    port = gpu_modes_round(PORT)
    assert port == ref
    _, devices, configs = ref
    assert devices["mig-0"] and devices["mps-0"] and configs


@pytest.mark.parametrize("seed", [1, 2])
def test_mig_and_mps_nodes_equal_across_packages_other_seeds(seed):
    for ns in NAMESPACES.values():
        reset(ns)
    assert gpu_modes_round(PORT, seed) == gpu_modes_round(REF, seed)


H100 = "NVIDIA-H100-80GB-HBM3"


def h100_mig_round(pk):
    cluster = pk.Cluster()
    state = pk.ClusterState()
    state.start_watching(cluster)
    clock = FakeClock()
    mig_node(pk, cluster, name="h100-0", gpus=1, model=H100)
    ctrl = make_controller(pk, cluster, state, pk.constants.KIND_MIG, pk.MigSnapshotTaker(),
                           pk.MigPartitioner(cluster), clock)
    for i, profile in enumerate(["1g.10gb", "3g.40gb", "7g.80gb"]):
        cluster.create(unschedulable_pod(pk, f"h-{i}", {f"nvidia.com/mig-{profile}": 1}))
    clock.advance(11)
    ctrl.process_batch_if_ready()
    node = cluster.get("Node", "", "h100-0")
    return (pk.model_known(H100), pk.ann.parse_spec(node.metadata.annotations),
            node.metadata.annotations.get(pk.constants.ANNOTATION_SPEC_PLAN))


@pytest.mark.parametrize("package", PACKAGES)
def test_h100_mig_node_left_unplanned(package):
    """The port keeps the reference's MIG tables (A30, A100): an H100 in
    MIG mode gets no spec in either package, until an operator registers
    its menu through `set_known_geometries`."""
    pk = NAMESPACES[package]
    for ns in NAMESPACES.values():
        reset(ns)
    assert h100_mig_round(pk) == (False, [], None)
    pk.set_known_geometries(H100, [{"1g.10gb": 7}])
    try:
        known, specs, plan = h100_mig_round(pk)
        assert known and plan and {s.profile for s in specs} == {"1g.10gb"}
    finally:
        pk.clear_known_geometry_overrides()
