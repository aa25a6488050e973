"""The port's scheduler, wiring, simulator, oracle and CLI
(`nos_tpu_torch/{scheduler,system,sim,sim_oracle,cli}.py`) against the JAX
package's on the same inputs, compared exactly once plan ids are stripped
(each plan carries a wall-clock stamp and a uuid4, `partitioning/core/
planner.py:78`, `controllers/slice_group.py:294`); no uid is compared
(each package counts its own):

- tests/test_perf_planner.py's group-mode round (:135): one 16x16 slice
  group of 64 hosts of 2x2, 100 gangs drawn with seed 0, both scheduler
  passes around one `GroupPartitioner` batch: each pass's result, every
  node's annotations and labels, every pod's node, phase and conditions;
- `WorkloadSim`'s and `MultiHostSim`'s `SimReport.to_dict()` and per-job
  records at the CI sizes of tests/test_simulation.py:17 and :156;
- `sim_oracle`'s fungible-chip floor (fifo and sjf) on
  `cli_single_host_trace(40)`;
- the JSON that `cli.main(["simulate", "--jobs", "40", "--nodes", "2",
  "--topology", "4x4"])` prints;
- `ControlPlane.tick()`'s result over tests/test_operations.py::
  test_control_plane_end_to_end's scenario, with the cluster it leaves.

Both packages' module-level state is reset before every case
(`torch_mirror.reset_state`); clocks are virtual; each test has a limit."""

import importlib
import json
import random
import types

import test_torch_fleet_parity as fp
import torch_mirror

PACKAGES = torch_mirror.PACKAGES

_time_limit = fp.time_limit(60)
_reset_state = torch_mirror.reset_state()

MODULES = ("constants", "api.objects", "api.quota_types", "api.resources", "cli", "sim",
           "sim_oracle", "system", "tpu", "tpulib")


def load(pkg):
    ns = types.SimpleNamespace(pkg=pkg)
    for name in MODULES:
        setattr(ns, name.split(".")[-1], importlib.import_module(f"{pkg}.{name}"))
    return ns


REF, PORT = (load(pkg) for pkg in PACKAGES)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def without_plan_ids(pk, annotations):
    ids = (pk.constants.ANNOTATION_SPEC_PLAN, pk.constants.ANNOTATION_STATUS_PLAN)
    return {k: v for k, v in annotations.items() if k not in ids}


def _phase(phase):
    return getattr(phase, "value", phase)


def cluster_state(pk, cluster):
    nodes = {n.metadata.name: (without_plan_ids(pk, n.metadata.annotations),
                               dict(n.metadata.labels), dict(n.status.allocatable))
             for n in cluster.list("Node")}
    pods = {p.metadata.namespaced_name: (
        p.spec.node_name, _phase(p.status.phase), dict(p.metadata.labels),
        sorted((c.type, c.status, c.reason) for c in p.status.conditions))
        for p in cluster.list("Pod")}
    return nodes, pods


def group_round(pk):
    """test_perf_planner.py:135's round on package `pk`, with test_multihost.py's
    `make_group`/`submit_gang`: both passes' results and the cluster after."""
    multihost = (importlib.import_module("test_multihost") if pk is REF
                 else torch_mirror.load("test_multihost"))
    clock = Clock()
    plane = pk.system.ControlPlane(now=clock).start()
    try:
        multihost.make_group(plane, "s0", global_topo="16x16", host_topo="2x2", grid=(8, 8))
        rng = random.Random(0)
        shapes = [("2x2", 1), ("2x4", 2), ("4x4", 4), ("4x8", 8), ("8x8", 16)]
        weights = [2.0 ** -i for i in range(len(shapes))]
        for j in range(100):
            topo, size = rng.choices(shapes, weights)[0]
            multihost.submit_gang(plane, f"g{j}", "ml", topo, size)
        first = plane.scheduler.schedule_pending()
        clock.t += 61
        assert plane.group_partitioner.process_batch_if_ready()
        second = plane.scheduler.schedule_pending()
        return first, second, cluster_state(pk, plane.cluster)
    finally:
        plane.stop()


def test_group_round_equal_across_packages():
    ref = group_round(REF)
    assert group_round(PORT) == ref
    first, second, (nodes, pods) = ref
    assert first["bound"] == [] and len(second["bound"]) > 0
    assert len(nodes) == 64 and len(pods) > 100
    bound = [name for name, (node, *_rest) in pods.items() if node]
    assert len(bound) == len(second["bound"])


def records(report):
    return [(r.job.name, r.bound_s, r.completed_s, r.preemptions) for r in report.jobs]


def single_host_sim(pk):
    """test_simulation.py:17's trace on 2 x v5e 4x4."""
    sim = pk.sim.WorkloadSim(topos={"a": "4x4", "b": "4x4"})
    jobs = pk.sim.mixed_workload(
        80,
        seed=7,
        profiles=(("1x1", 0.4), ("2x2", 0.35), ("2x4", 0.2), ("4x4", 0.05)),
        mean_interarrival_s=1.0,
        duration_range_s=(30.0, 120.0),
    )
    report = sim.run(jobs, measure_window=(60.0, 300.0), max_s=3600.0)
    return report.to_dict(), records(report)


def multihost_sim(pk):
    """test_simulation.py:156's trace on one 8x8 group of 16 hosts of 2x2."""
    sim = pk.sim.MultiHostSim(groups={"s0": ("8x8", "2x2", (4, 4))})
    jobs = pk.sim.mixed_gang_workload(
        40,
        seed=5,
        shapes=(("2x2", 1, 0.4), ("2x4", 2, 0.3), ("4x4", 4, 0.2), ("4x8", 8, 0.1)),
        mean_interarrival_s=2.0,
        duration_range_s=(30.0, 120.0),
    )
    report = sim.run(jobs, measure_window=(60.0, 240.0), max_s=3600.0)
    return report.to_dict(), records(report)


def test_workload_sim_report_equal_across_packages():
    ref = single_host_sim(REF)
    assert single_host_sim(PORT) == ref
    report, jobs = ref
    assert report["completed"] == 80 and report["utilization_window"] >= 0.85
    assert len(jobs) == 80


def test_multihost_sim_report_equal_across_packages():
    ref = multihost_sim(REF)
    assert multihost_sim(PORT) == ref
    report, jobs = ref
    assert report["completed"] == 40 and report["utilization_window"] >= 0.85
    assert len(jobs) == 40


def oracle_floor(pk):
    jobs = pk.sim_oracle.from_sim_jobs(pk.sim.cli_single_host_trace(40))
    out = {}
    for policy in ("fifo", "sjf"):
        r = pk.sim_oracle.oracle_schedule(jobs, total_chips=256, policy=policy)
        out[policy] = (r.latencies, r.makespan_s, r.p50_latency_s, r.p95_latency_s)
    return out


def test_oracle_floor_equal_across_packages():
    ref = oracle_floor(REF)
    assert oracle_floor(PORT) == ref
    assert len(ref["fifo"][0]) == 40


CLI_SIMULATE = ["simulate", "--jobs", "40", "--nodes", "2", "--topology", "4x4"]


def test_cli_simulate_json_equal_across_packages(capsys):
    printed = {}
    for pk in (REF, PORT):
        assert pk.cli.main(CLI_SIMULATE) == 0
        printed[pk.pkg] = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed["nos_tpu_torch"] == printed["nos_tpu"]
    report = json.loads(printed["nos_tpu"])
    assert report["jobs"] == 40 and report["completed"] == 40 and report["total_chips"] == 32


def control_plane_tick(pk):
    """test_operations.py::test_control_plane_end_to_end's scenario: one
    4x4 node with its agent, a quota, a 2x2 pod; the tick's result and the
    cluster it leaves."""
    C, o, R = pk.constants, pk.objects, pk.resources.ResourceList
    clock = Clock()
    plane = pk.system.ControlPlane(now=clock).start()
    try:
        plane.cluster.create(o.Node(
            metadata=o.ObjectMeta(name="tpu-node-0", labels={
                C.LABEL_PARTITIONING: C.KIND_TPU,
                C.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                C.LABEL_TPU_TOPOLOGY: "4x4",
            }),
            status=o.NodeStatus(allocatable=R.of({"cpu": 64, C.RESOURCE_TPU: 16})),
        ))
        plane.add_tpu_agent("tpu-node-0",
                            client=pk.tpulib.FakeTpuClient(pk.tpu.Topology.parse("v5e", "4x4")))
        plane.cluster.create(pk.quota_types.build_eq(
            "ml", "q", min={C.RESOURCE_ACCELERATOR_MEMORY: 128}))
        plane.cluster.create(o.Pod(
            metadata=o.ObjectMeta(name="job", namespace="ml"),
            spec=o.PodSpec(containers=[o.Container(
                resources=R.of({"google.com/tpu-2x2": 1, "cpu": 1}))],
                scheduler_name=C.SCHEDULER_NAME),
        ))
        before = plane.scheduler.schedule_pending()
        clock.t += 61
        result = plane.tick()
        return before, result, cluster_state(pk, plane.cluster)
    finally:
        plane.stop()


def test_control_plane_tick_equal_across_packages():
    ref = control_plane_tick(REF)
    assert control_plane_tick(PORT) == ref
    _, result, (nodes, pods) = ref
    assert result["second_pass"]["bound"] or result["first_pass"]["bound"]
    node, phase, labels, _ = pods["ml/job"]
    assert node == "tpu-node-0" and phase == "Running"
    assert labels.get(REF.constants.LABEL_CAPACITY) == REF.constants.CAPACITY_IN_QUOTA
