"""The port's controllers (`nos_tpu_torch/controllers/`) and the scheduler's
quota pieces (`scheduler/{resource_calculator,quota_info}.py`) against the
JAX package's.

- The cases of tests/test_quota_info.py, test_quota_operator.py (all but
  `test_operator_plus_scheduler_preemption_path`, which needs
  `scheduler.Scheduler`) and test_kube_backend.py (all but
  `TestApiserverCli`, which needs `cli`), each run on both packages with
  the reference's assertions: every name the reference imports from
  `nos_tpu` is read from the package under test (`pk.<name>`), and every
  helper takes that namespace first.
- test_fault_recovery.py's four cases on both packages, driven as the
  reference drives them: test_full_system.py's `System` and
  test_multihost.py's `build_plane` over the package's own `Scheduler`
  (with `SchedulerSim` as the partitioner's simulated scheduler) and
  `ControlPlane`.
- Across packages, exact equality once the plan ids are stripped:
  `QuotaReconciler` over a seeded pod churn (each ElasticQuota's `used`
  and every pod's capacity label), and `GroupPartitioner` with
  `HostAgent`s on test_fault_recovery.py's group before and after a
  partitioner restart (the carve, the ack labels, the bindings), each
  package through its own `ControlPlane`.

The `pk` fixture resets both packages' `observability.metrics` registry
before every case; every server binds port 0 and stops in a finalizer;
clocks are the reference tests' fake clocks; each test has a limit
(SIGALRM)."""

import importlib
import os
import random
import time
import types

import pytest

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(90)

# What the reference files import from `nos_tpu`, by module ("name as
# alias" where they rename).
NAMES = {
    "": ["constants"],
    "api": ["annotations as ann"],
    "api.objects": ["ConfigMap", "Container", "Node", "NodeStatus", "ObjectMeta",
                    "OwnerReference", "Pod", "PodCondition", "PodDisruptionBudget",
                    "PodDisruptionBudgetSpec", "PodPhase", "PodSpec", "PodStatus"],
    "api.quota_types": ["build_composite_eq", "build_eq"],
    "api.resources": ["ResourceList", "compute_pod_request"],
    "api.webhooks": ["install_quota_webhooks"],
    "cluster": ["Cluster"],
    "cluster.apiserver": ["ClusterAPIServer"],
    "cluster.client": ["AdmissionError", "AlreadyExistsError", "ConflictError", "EventType",
                       "NotFoundError"],
    "cluster.kube": ["KubeCluster", "KubeConfig", "compute_merge_patch"],
    "cluster.serialize": ["KINDS", "from_wire", "to_wire"],
    "cluster.webhook_server": ["AdmissionWebhookServer"],
    "controllers.partitioner": ["PartitionerController"],
    "controllers.quota": ["QuotaReconciler"],
    "controllers.slice_group": ["GroupPartitioner", "HostAgent"],
    "controllers.tpu_agent": ["TpuAgent"],
    "partitioning.state": ["ClusterState"],
    "partitioning.tpu_mode": ["TpuPartitioner", "TpuSnapshotTaker"],
    "scheduler.quota_info": ["ElasticQuotaInfos"],
    "scheduler.scheduler": ["Scheduler"],
    "system": ["ControlPlane", "SchedulerSim"],
    "scheduler.resource_calculator": ["ResourceCalculator"],
    "tpu": ["Profile", "Topology"],
    "tpulib": ["FakeTpuClient"],
    "util": ["pod as podutil"],
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
    return ns


NAMESPACES = {pkg: load(pkg) for pkg in PACKAGES}
REF, PORT = NAMESPACES["nos_tpu"], NAMESPACES["nos_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pk(request):
    for ns in NAMESPACES.values():
        ns.metrics.__init__()
    return NAMESPACES[request.param]


# -- test_quota_info.py -------------------------------------------------------
def infos(pk, *quotas, ceqs=()):
    return pk.ElasticQuotaInfos.from_objects(quotas, ceqs)


def test_from_objects_and_namespace_lookup(pk):
    qs = infos(pk, 
        pk.build_eq("ns-a", "qa", min={"cpu": 4}),
        pk.build_eq("ns-b", "qb", min={"cpu": 2}, max={"cpu": 10}),
    )
    assert len(qs) == 2
    a = qs.for_namespace("ns-a")
    assert a is not None and a.min["cpu"] == 4 and a.max is None
    assert qs.for_namespace("nope") is None


def test_composite_shadows_member_namespaces(pk):
    qs = infos(pk, 
        pk.build_eq("ns-a", "qa", min={"cpu": 4}),
        pk.build_eq("ns-c", "qc", min={"cpu": 1}),
        ceqs=[pk.build_composite_eq("team", ["ns-a", "ns-b"], min={"cpu": 8})],
    )
    a = qs.for_namespace("ns-a")
    assert a.composite and a.name == "ceq/team"
    assert qs.for_namespace("ns-b").name == "ceq/team"
    assert qs.for_namespace("ns-c").name == "eq/ns-c/qc"


def test_over_min_and_max(pk):
    qs = infos(pk, pk.build_eq("ns-a", "qa", min={"cpu": 4}, max={"cpu": 6}))
    a = qs.for_namespace("ns-a")
    req = pk.ResourceList.of({"cpu": 3})
    assert not a.is_over_min_with(req)
    a.add_used(pk.ResourceList.of({"cpu": 2}))
    assert a.is_over_min_with(req)  # 2+3 > 4
    assert a.fits_max(req)  # 2+3 <= 6
    assert not a.fits_max(pk.ResourceList.of({"cpu": 5}))  # 2+5 > 6


def test_aggregated_borrow_guard(pk):
    qs = infos(pk, 
        pk.build_eq("ns-a", "qa", min={"cpu": 4}),
        pk.build_eq("ns-b", "qb", min={"cpu": 4}),
    )
    qs.for_namespace("ns-a").add_used(pk.ResourceList.of({"cpu": 6}))  # borrowing 2
    # Σmin=8, Σused=6 -> only 2 cpu left to borrow.
    assert qs.aggregated_used_fits_total_min(pk.ResourceList.of({"cpu": 2}))
    assert not qs.aggregated_used_fits_total_min(pk.ResourceList.of({"cpu": 3}))


def test_guaranteed_overquotas_proportional_to_min(pk):
    # Pool = (4-0) + (8-8) + (4-2) = 6 unused cpu; shares 4:8:4.
    qs = infos(pk, 
        pk.build_eq("ns-a", "qa", min={"cpu": 4}),
        pk.build_eq("ns-b", "qb", min={"cpu": 8}),
        pk.build_eq("ns-c", "qc", min={"cpu": 4}),
    )
    qs.for_namespace("ns-b").add_used(pk.ResourceList.of({"cpu": 8}))
    qs.for_namespace("ns-c").add_used(pk.ResourceList.of({"cpu": 2}))
    g_a = qs.guaranteed_overquotas("eq/ns-a/qa")
    g_b = qs.guaranteed_overquotas("eq/ns-b/qb")
    assert g_a["cpu"] == pytest.approx(6 * 4 / 16)
    assert g_b["cpu"] == pytest.approx(6 * 8 / 16)
    assert qs.guaranteed_overquotas("missing") == {}


def test_clone_is_independent(pk):
    qs = infos(pk, pk.build_eq("ns-a", "qa", min={"cpu": 4}))
    c = qs.clone()
    c.for_namespace("ns-a").add_used(pk.ResourceList.of({"cpu": 2}))
    assert qs.for_namespace("ns-a").used == {}


# -- test_quota_operator.py ---------------------------------------------------
CPU = "cpu"


def running_pod(pk, name, ns, cpu, node="n1", priority=0, created=0.0):
    p = pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns, creation_timestamp=created),
        spec=pk.PodSpec(
            containers=[pk.Container(resources=pk.ResourceList.of({CPU: cpu}))],
            priority=priority,
        ),
    )
    p.spec.node_name = node
    p.status.phase = pk.PodPhase.RUNNING
    return p


# -- webhooks ----------------------------------------------------------------
def test_webhook_rejects_second_eq_in_namespace(pk):
    cluster = pk.Cluster()
    pk.install_quota_webhooks(cluster)
    cluster.create(pk.build_eq("ns-a", "q1", min={CPU: 2}))
    with pytest.raises(pk.AdmissionError):
        cluster.create(pk.build_eq("ns-a", "q2", min={CPU: 1}))


def test_webhook_rejects_min_above_max(pk):
    cluster = pk.Cluster()
    pk.install_quota_webhooks(cluster)
    with pytest.raises(pk.AdmissionError):
        cluster.create(pk.build_eq("ns-a", "q1", min={CPU: 4}, max={CPU: 2}))


def test_webhook_rejects_eq_in_ceq_namespace_and_ceq_overlap(pk):
    cluster = pk.Cluster()
    pk.install_quota_webhooks(cluster)
    cluster.create(pk.build_composite_eq("team", ["ns-a", "ns-b"], min={CPU: 4}))
    with pytest.raises(pk.AdmissionError):
        cluster.create(pk.build_eq("ns-a", "q1", min={CPU: 1}))
    with pytest.raises(pk.AdmissionError):
        cluster.create(pk.build_composite_eq("team2", ["ns-b", "ns-c"], min={CPU: 1}))
    with pytest.raises(pk.AdmissionError):
        cluster.create(pk.build_composite_eq("empty", [], min={CPU: 1}))


# -- reconciler --------------------------------------------------------------
def test_over_quota_labeling_and_used_status(pk):
    cluster = pk.Cluster()
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()

    cluster.create(pk.build_eq("ns-a", "q", min={CPU: 4}))
    cluster.create(running_pod(pk, "p1", "ns-a", 3, created=1.0))
    cluster.create(running_pod(pk, "p2", "ns-a", 3, created=2.0))

    p1 = cluster.get("Pod", "ns-a", "p1")
    p2 = cluster.get("Pod", "ns-a", "p2")
    assert p1.metadata.labels[pk.constants.LABEL_CAPACITY] == pk.constants.CAPACITY_IN_QUOTA
    assert p2.metadata.labels[pk.constants.LABEL_CAPACITY] == pk.constants.CAPACITY_OVER_QUOTA
    eq = cluster.get("ElasticQuota", "ns-a", "q")
    assert eq.status.used[CPU] == 6


def test_labels_flip_when_pod_finishes(pk):
    cluster = pk.Cluster()
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()

    cluster.create(pk.build_eq("ns-a", "q", min={CPU: 4}))
    cluster.create(running_pod(pk, "early", "ns-a", 3, created=1.0))
    cluster.create(running_pod(pk, "late", "ns-a", 3, created=2.0))
    assert (
        cluster.get("Pod", "ns-a", "late").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_OVER_QUOTA
    )
    # The early pod finishes -> the late pod falls within min.
    cluster.patch(
        "Pod", "ns-a", "early", lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED)
    )
    assert (
        cluster.get("Pod", "ns-a", "late").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_IN_QUOTA
    )
    assert cluster.get("ElasticQuota", "ns-a", "q").status.used[CPU] == 3


def test_priority_breaks_creation_ties(pk):
    cluster = pk.Cluster()
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()
    cluster.create(pk.build_eq("ns-a", "q", min={CPU: 4}))
    cluster.create(running_pod(pk, "low", "ns-a", 3, priority=0, created=1.0))
    cluster.create(running_pod(pk, "high", "ns-a", 3, priority=10, created=1.0))
    assert (
        cluster.get("Pod", "ns-a", "high").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_IN_QUOTA
    )
    assert (
        cluster.get("Pod", "ns-a", "low").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_OVER_QUOTA
    )


def test_composite_quota_spans_namespaces_and_deletes_overlapping_eq(pk):
    cluster = pk.Cluster()
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()

    cluster.create(pk.build_eq("ns-a", "old-q", min={CPU: 1}))
    cluster.create(pk.build_composite_eq("team", ["ns-a", "ns-b"], min={CPU: 4}))
    # Overlapping EQ got deleted by the composite reconciler.
    assert cluster.try_get("ElasticQuota", "ns-a", "old-q") is None

    cluster.create(running_pod(pk, "pa", "ns-a", 2, created=1.0))
    cluster.create(running_pod(pk, "pb", "ns-b", 3, created=2.0))
    assert (
        cluster.get("Pod", "ns-a", "pa").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_IN_QUOTA
    )
    assert (
        cluster.get("Pod", "ns-b", "pb").metadata.labels[pk.constants.LABEL_CAPACITY]
        == pk.constants.CAPACITY_OVER_QUOTA
    )
    ceq = cluster.get("CompositeElasticQuota", "default", "team")
    assert ceq.status.used[CPU] == 5


def test_quota_metering_only_named_resources(pk):
    cluster = pk.Cluster()
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()
    cluster.create(pk.build_eq("ns-a", "q", min={CPU: 4}))
    pod = running_pod(pk, "p", "ns-a", 1)
    pod.spec.containers[0].resources["memory"] = float(2**30)
    cluster.create(pod)
    eq = cluster.get("ElasticQuota", "ns-a", "q")
    assert eq.status.used == {CPU: 1}  # memory unmetered


# -- test_kube_backend.py -----------------------------------------------------
def wait_for(cond, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def make_pod(pk, name, ns="default", phase=None, cpu=1.0, tpu=0.0, node=""):
    phase = pk.PodPhase.RUNNING if phase is None else phase
    res = pk.ResourceList.of({"cpu": cpu})
    if tpu:
        res[pk.constants.RESOURCE_TPU] = tpu
    return pk.Pod(
        metadata=pk.ObjectMeta(name=name, namespace=ns, labels={"app": name}),
        spec=pk.PodSpec(containers=[pk.Container("main", res)], node_name=node),
        status=pk.PodStatus(phase=phase),
    )


# -- wire codec --------------------------------------------------------------
class TestSerialize:
    def full_objects(self, pk):
        pod = make_pod(pk, "p1", tpu=4, node="host-0")
        pod.metadata.annotations["tpu.nos/spec-partitioning-plan"] = "42"
        pod.spec.priority = 100
        pod.spec.overhead = pk.ResourceList.of({"cpu": "100m"})
        pod.spec.node_selector = {"pool": "tpu"}
        pod.spec.init_containers = [pk.Container("init", pk.ResourceList.of({"cpu": 2}))]
        pod.spec.scheduler_name = "nos-scheduler"
        pod.status.conditions = [pk.PodCondition("PodScheduled", "False", "Unschedulable")]
        pod.status.nominated_node_name = "host-1"
        pod.owner_references = [pk.OwnerReference("Job", "trainer")]
        pod.metadata.creation_timestamp = 1700000000.123456
        node = pk.Node(
            metadata=pk.ObjectMeta(name="host-0", labels={"tpu.nos/partitioning": "tpu"}),
            status=pk.NodeStatus(
                capacity=pk.ResourceList.of({"cpu": 8, pk.constants.RESOURCE_TPU: 8}),
                allocatable=pk.ResourceList.of({"cpu": "7500m", pk.constants.RESOURCE_TPU: 8}),
            ),
        )
        cm = pk.ConfigMap(
            metadata=pk.ObjectMeta(name="dp-config", namespace="kube-system"),
            data={"config.yaml": "a: 1\n"},
        )
        pdb = pk.PodDisruptionBudget(
            metadata=pk.ObjectMeta(name="pdb", namespace="default"),
            spec=pk.PodDisruptionBudgetSpec(selector={"app": "x"}, min_available=2),
        )
        eq = pk.build_eq("team-a", "quota-a", min={"cpu": 4, pk.constants.RESOURCE_TPU: 8})
        eq.status.used = pk.ResourceList.of({"cpu": "1500m"})
        ceq = pk.build_composite_eq("shared", ["team-a", "team-b"], min={"cpu": 10}, max={"cpu": 20})
        return [pod, node, cm, pdb, eq, ceq]

    def test_round_trip_all_kinds(self, pk):
        for obj in self.full_objects(pk):
            obj.metadata.resource_version = 7
            wire = pk.to_wire(obj)
            back = pk.from_wire(wire)
            assert pk.to_wire(back) == wire, f"{type(obj).__name__} not stable"
            assert back.metadata.name == obj.metadata.name
            assert back.metadata.resource_version == 7

    def test_pod_semantic_round_trip(self, pk):
        pod = self.full_objects(pk)[0]
        back = pk.from_wire(pk.to_wire(pod))
        assert back.spec.containers[0].resources == pod.spec.containers[0].resources
        assert back.spec.overhead.get_q("cpu") == pytest.approx(0.1)
        assert back.spec.priority == 100
        assert back.owner_references[0].kind == "Job"
        assert back.status.conditions[0].reason == "Unschedulable"
        assert back.metadata.creation_timestamp == pytest.approx(1700000000.123456, abs=1e-5)

    def test_quantity_spellings(self, pk):
        rl = pk.ResourceList.of({"cpu": "250m", "memory": "2Gi", pk.constants.RESOURCE_TPU: 4})
        wire = pk.to_wire(pk.Node(metadata=pk.ObjectMeta(name="n"), status=pk.NodeStatus(capacity=rl)))
        cap = wire["status"]["capacity"]
        assert cap["cpu"] == "250m"
        assert cap["memory"] == str(2 * 2**30)
        back = pk.from_wire(wire)
        assert back.status.capacity == rl

    def test_merge_patch_computation(self, pk):
        old = {"a": 1, "b": {"x": 1, "y": 2}, "c": [1, 2]}
        new = {"a": 1, "b": {"x": 9}, "c": [1, 2, 3], "d": "new"}
        patch = pk.compute_merge_patch(old, new)
        assert patch == {"b": {"x": 9, "y": None}, "c": [1, 2, 3], "d": "new"}
        assert pk.compute_merge_patch(old, old) is None


# -- emulator + client -------------------------------------------------------
@pytest.fixture()
def api(pk):
    server = pk.ClusterAPIServer().start()
    kube = pk.KubeCluster(pk.KubeConfig(server=server.url))
    yield server, kube
    kube.close()
    server.stop()


class TestKubeClusterCrud:
    def test_create_get_list_delete(self, pk, api):
        _, kube = api
        stored = kube.create(make_pod(pk, "p1"))
        assert stored.metadata.resource_version > 0
        got = kube.get("Pod", "default", "p1")
        assert got.spec.containers[0].resources.get_q("cpu") == 1.0
        kube.create(make_pod(pk, "p2", ns="other"))
        assert [p.metadata.name for p in kube.list("Pod")] == ["p1", "p2"]
        assert [p.metadata.name for p in kube.list("Pod", namespace="other")] == ["p2"]
        assert [p.metadata.name for p in kube.list("Pod", label_selector={"app": "p2"})] == ["p2"]
        kube.delete("Pod", "default", "p1")
        assert kube.try_get("Pod", "default", "p1") is None
        with pytest.raises(pk.NotFoundError):
            kube.get("Pod", "default", "p1")
        with pytest.raises(pk.NotFoundError):
            kube.delete("Pod", "default", "p1")

    def test_create_conflict(self, pk, api):
        _, kube = api
        kube.create(make_pod(pk, "dup"))
        with pytest.raises(pk.AlreadyExistsError):
            kube.create(make_pod(pk, "dup"))

    def test_update_occ_conflict(self, pk, api):
        _, kube = api
        kube.create(make_pod(pk, "p"))
        a = kube.get("Pod", "default", "p")
        b = kube.get("Pod", "default", "p")
        a.spec.node_name = "host-a"
        kube.update(a)
        b.spec.node_name = "host-b"
        with pytest.raises(pk.ConflictError):
            kube.update(b)

    def test_cluster_scoped_node(self, pk, api):
        _, kube = api
        node = pk.Node(metadata=pk.ObjectMeta(name="host-0"))
        node.status.capacity = pk.ResourceList.of({"cpu": 8})
        kube.create(node)
        got = kube.get("Node", "", "host-0")
        assert got.status.capacity.get_q("cpu") == 8.0
        assert [n.metadata.name for n in kube.list("Node")] == ["host-0"]

    def test_patch_annotations(self, pk, api):
        _, kube = api
        kube.create(pk.Node(metadata=pk.ObjectMeta(name="host-0")))

        def annotate(n):
            n.metadata.annotations["tpu.nos/spec-partitioning-plan"] = "plan-1"

        stored = kube.patch("Node", "", "host-0", annotate)
        assert stored.metadata.annotations["tpu.nos/spec-partitioning-plan"] == "plan-1"
        # no-op patch issues no write: rv unchanged
        again = kube.patch("Node", "", "host-0", annotate)
        assert again.metadata.resource_version == stored.metadata.resource_version

    def test_status_subresource_isolation(self, pk, api):
        server, kube = api
        eq = pk.build_eq("team-a", "quota", min={"cpu": 4})
        kube.create(eq)

        # a spec-only patch must not clobber independently-written status
        def set_used(q):
            q.status.used = pk.ResourceList.of({"cpu": 2})

        kube.patch("ElasticQuota", "team-a", "quota", set_used)

        def bump_min(q):
            q.spec.min = pk.ResourceList.of({"cpu": 8})

        kube.patch("ElasticQuota", "team-a", "quota", bump_min)
        got = kube.get("ElasticQuota", "team-a", "quota")
        assert got.spec.min.get_q("cpu") == 8.0
        assert got.status.used.get_q("cpu") == 2.0

    def test_patch_retries_past_conflicting_writer(self, pk, api):
        """RMW patch converges when another writer races it (bounded retry on
        409, reference controller-runtime client does the same)."""
        server, kube = api
        kube.create(pk.Node(metadata=pk.ObjectMeta(name="n")))
        hits = {"n": 0}

        def slow_patch(n):
            hits["n"] += 1
            if hits["n"] == 1:
                # sneak a competing write in between GET and PATCH
                server.cluster.patch(
                    "Node", "", "n",
                    lambda o: o.metadata.labels.__setitem__("racer", "yes"),
                )
            n.metadata.labels["mine"] = "yes"

        kube.patch("Node", "", "n", slow_patch)
        got = kube.get("Node", "", "n")
        assert got.metadata.labels == {"racer": "yes", "mine": "yes"}
        assert hits["n"] == 2


class TestKubeWatch:
    def test_watch_add_modify_delete_with_old_obj(self, pk, api):
        _, kube = api
        kube.create(make_pod(pk, "existing"))
        events = []
        unsub = kube.watch("Pod", events.append)
        wait_for(lambda: len(events) >= 1, msg="replay ADDED")
        assert events[0].type == pk.EventType.ADDED
        assert events[0].obj.metadata.name == "existing"

        kube.patch(
            "Pod", "default", "existing",
            lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED),
        )
        wait_for(
            lambda: any(e.type == pk.EventType.MODIFIED for e in events), msg="MODIFIED"
        )
        mod = next(e for e in events if e.type == pk.EventType.MODIFIED)
        assert mod.obj.status.phase == pk.PodPhase.SUCCEEDED
        assert mod.old_obj is not None and mod.old_obj.status.phase == pk.PodPhase.RUNNING

        kube.delete("Pod", "default", "existing")
        wait_for(
            lambda: any(e.type == pk.EventType.DELETED for e in events), msg="DELETED"
        )
        unsub()
        n = len(events)
        kube.create(make_pod(pk, "after-unsub"))
        time.sleep(0.2)
        assert len(events) == n

    def test_watch_without_replay(self, pk, api):
        _, kube = api
        kube.create(make_pod(pk, "pre"))
        events = []
        kube.watch("Pod", events.append, replay=False)
        # replay suppressed: only live events arrive
        kube.create(make_pod(pk, "live"))
        wait_for(lambda: any(e.obj.metadata.name == "live" for e in events), msg="live event")
        assert not any(e.obj.metadata.name == "pre" and e.type == pk.EventType.ADDED for e in events)


class TestInformerResilience:
    def test_informer_reconnects_and_resyncs_after_apiserver_restart(self, pk):
        """Kill the API server mid-watch, mutate state while it's down, and
        bring it back on the same port with the same store (etcd survives an
        apiserver restart): the informer must reconnect, re-list, and
        synthesize the delta it missed (client-go re-sync semantics)."""
        backing = pk.Cluster()
        server = pk.ClusterAPIServer(backing).start()
        port = server._httpd.server_address[1]
        kube = pk.KubeCluster(pk.KubeConfig(server=server.url))
        try:
            events = []
            kube.watch("Pod", events.append)
            backing.create(make_pod(pk, "before", node="host-0"))
            wait_for(
                lambda: any(e.obj.metadata.name == "before" for e in events),
                msg="pre-restart event",
            )

            server.stop()  # watch streams die; informer begins backoff
            # state moves while the apiserver is down
            backing.create(make_pod(pk, "during", node="host-0"))
            backing.patch(
                "Pod", "default", "before",
                lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED),
            )

            server = pk.ClusterAPIServer(backing, port=port).start()
            wait_for(
                lambda: any(
                    e.type == pk.EventType.ADDED and e.obj.metadata.name == "during"
                    for e in events
                ),
                timeout=30,
                msg="missed-create synthesized after reconnect",
            )
            wait_for(
                lambda: any(
                    e.type == pk.EventType.MODIFIED
                    and e.obj.metadata.name == "before"
                    and e.obj.status.phase == pk.PodPhase.SUCCEEDED
                    for e in events
                ),
                timeout=30,
                msg="missed-modify synthesized after reconnect",
            )
            # and live watching resumes
            backing.create(make_pod(pk, "after", node="host-0"))
            wait_for(
                lambda: any(e.obj.metadata.name == "after" for e in events),
                timeout=30,
                msg="live events after reconnect",
            )
        finally:
            kube.close()
            server.stop()


# -- admission over AdmissionReview ------------------------------------------
class TestWebhooksOverHttp:
    @pytest.fixture()
    def stack(self, pk):
        server = pk.ClusterAPIServer().start()
        kube = pk.KubeCluster(pk.KubeConfig(server=server.url))
        pk.install_quota_webhooks(kube)  # populates kube.webhooks registry
        hook_server = pk.AdmissionWebhookServer(kube.webhooks).start()
        server.add_remote_webhook("ElasticQuota", hook_server.url)
        server.add_remote_webhook("CompositeElasticQuota", hook_server.url)
        yield server, kube
        hook_server.stop()
        kube.close()
        server.stop()

    def test_one_eq_per_namespace(self, pk, stack):
        _, kube = stack
        kube.create(pk.build_eq("team-a", "first", min={"cpu": 1}))
        with pytest.raises(pk.AdmissionError, match="already has ElasticQuota"):
            kube.create(pk.build_eq("team-a", "second", min={"cpu": 1}))
        # other namespaces unaffected
        kube.create(pk.build_eq("team-b", "first", min={"cpu": 1}))

    def test_eq_ceq_overlap_rejected(self, pk, stack):
        _, kube = stack
        kube.create(pk.build_composite_eq("shared", ["team-x", "team-y"], min={"cpu": 4}))
        with pytest.raises(pk.AdmissionError, match="claimed by CompositeElasticQuota"):
            kube.create(pk.build_eq("team-x", "q", min={"cpu": 1}))

    def test_min_exceeding_max_rejected(self, pk, stack):
        _, kube = stack
        with pytest.raises(pk.AdmissionError, match="exceeds max"):
            kube.create(pk.build_eq("team-a", "bad", min={"cpu": 8}, max={"cpu": 4}))


# -- the reconciler, unmodified, over HTTP ------------------------------------
class TestQuotaReconcilerOverHttp:
    @pytest.fixture()
    def stack(self, pk):
        server = pk.ClusterAPIServer().start()
        kube = pk.KubeCluster(pk.KubeConfig(server=server.url))
        rec = pk.QuotaReconciler(kube)
        rec.start_watching()
        yield server, kube, rec
        rec.stop()
        kube.close()
        server.stop()

    def test_eq_labels_and_used_over_http(self, pk, stack):
        _, kube, _ = stack
        kube.create(pk.build_eq("team-a", "quota", min={"cpu": 2}))
        kube.create(make_pod(pk, "a1", ns="team-a", cpu=1.5, node="host-0"))
        kube.create(make_pod(pk, "a2", ns="team-a", cpu=1.5, node="host-0"))

        def settled():
            eq = kube.get("ElasticQuota", "team-a", "quota")
            if eq.status.used.get_q("cpu") != 3.0:
                return False
            labels = {
                p.metadata.name: p.metadata.labels.get(pk.constants.LABEL_CAPACITY)
                for p in kube.list("Pod", namespace="team-a")
            }
            return set(labels.values()) == {
                pk.constants.CAPACITY_IN_QUOTA,
                pk.constants.CAPACITY_OVER_QUOTA,
            }

        wait_for(settled, msg="EQ reconciled over HTTP")

    def test_pod_completion_releases_quota(self, pk, stack):
        _, kube, _ = stack
        kube.create(pk.build_eq("team-a", "quota", min={"cpu": 2}))
        kube.create(make_pod(pk, "a1", ns="team-a", cpu=1.5, node="host-0"))
        wait_for(
            lambda: kube.get("ElasticQuota", "team-a", "quota").status.used.get_q("cpu") == 1.5,
            msg="used=1.5",
        )
        kube.patch(
            "Pod", "team-a", "a1",
            lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED),
        )
        wait_for(
            lambda: kube.get("ElasticQuota", "team-a", "quota").status.used.get_q("cpu") == 0.0,
            msg="used released",
        )

    def test_ceq_deletes_overlapping_eq_over_http(self, pk, stack):
        _, kube, _ = stack
        kube.create(pk.build_eq("team-a", "old-quota", min={"cpu": 1}))
        kube.create(pk.build_composite_eq("shared", ["team-a", "team-b"], min={"cpu": 4}))
        wait_for(
            lambda: kube.try_get("ElasticQuota", "team-a", "old-quota") is None,
            msg="overlapped EQ deleted",
        )


# -- HTTPS webhook serving (in-cluster TLS path) ------------------------------
class TestWebhookTls:
    def test_admission_review_over_https(self, pk, tmp_path):
        """The in-cluster path: AdmissionWebhookServer serves HTTPS with a
        cert-manager-style tls.crt/tls.key pair; a review round-trips."""
        import json
        import ssl
        import subprocess
        import urllib.request

        crt, key = str(tmp_path / "tls.crt"), str(tmp_path / "tls.key")
        subprocess.run(
            [
                "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", key, "-out", crt, "-days", "1",
                "-subj", "/CN=localhost",
            ],
            check=True,
            capture_output=True,
        )

        registry = {}
        kube_like = type("R", (), {"webhooks": registry})()
        install_quota_webhooks_into(pk, registry)
        server = pk.AdmissionWebhookServer(registry, certfile=crt, keyfile=key).start()
        try:
            assert server.url.startswith("https://")
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": "u1",
                    "operation": "CREATE",
                    "object": pk.to_wire(pk.build_eq("ns", "bad", min={"cpu": 8}, max={"cpu": 4})),
                },
            }
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            req = urllib.request.Request(
                server.url,
                data=json.dumps(review).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
                body = json.loads(resp.read())
            assert body["response"]["allowed"] is False
            assert "exceeds max" in body["response"]["status"]["message"]

            # A half-open client (TCP connect, no TLS handshake) must not
            # block the accept loop: reviews keep flowing (the handshake is
            # deferred to the per-connection handler thread).
            import socket

            host, port = server._httpd.server_address[:2]
            loris = socket.create_connection((host, port), timeout=10)
            try:
                with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
                    body = json.loads(resp.read())
                assert body["response"]["allowed"] is False
            finally:
                loris.close()
        finally:
            server.stop()


def install_quota_webhooks_into(pk, registry):
    """Adapt install_quota_webhooks to a bare registry: validation that needs
    cluster reads gets an empty in-memory cluster (min/max checks don't)."""
    backing = pk.Cluster()
    pk.install_quota_webhooks(backing)
    registry.update(backing._webhooks)


# -- the CLI apiserver command (make cluster backbone) ------------------------


# -- true-cluster smoke test (requires a live kubeconfig) ---------------------
@pytest.mark.skipif(
    not os.environ.get("NOS_E2E_KUBECONFIG"),
    reason="set NOS_E2E_KUBECONFIG to a kubeconfig for a live cluster",
)
class TestLiveCluster:
    def test_nodes_listable(self, pk):
        kube = pk.KubeCluster(kubeconfig_path=os.environ["NOS_E2E_KUBECONFIG"])
        nodes = kube.list("Node")
        assert isinstance(nodes, list)


# -- test_fault_recovery.py ---------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class System:
    """tests/test_full_system.py's `System`: one TPU node (4x4) with its
    agent, the TPU partitioner and the package's `Scheduler`."""

    def __init__(self, pk, topos={"tpu-node-0": "4x4"}):
        self.pk = pk
        self.cluster = pk.Cluster()
        self.state = pk.ClusterState()
        self.state.start_watching(self.cluster)
        self.clock = FakeClock()
        self.scheduler = pk.Scheduler(self.cluster)
        self.agents = {}
        for name, topo in topos.items():
            self.cluster.create(
                pk.Node(
                    metadata=pk.ObjectMeta(
                        name=name,
                        labels={
                            pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU,
                            pk.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                            pk.constants.LABEL_TPU_TOPOLOGY: topo,
                        },
                    ),
                    status=pk.NodeStatus(
                        allocatable=pk.ResourceList.of(
                            {"cpu": 64, "memory": "128Gi",
                             "google.com/tpu": pk.Topology.parse("v5e", topo).chips}
                        )
                    ),
                )
            )
            agent = pk.TpuAgent(self.cluster, name, pk.FakeTpuClient(pk.Topology.parse("v5e", topo)))
            agent.startup()
            agent.start_watching()
            self.agents[name] = agent
        self.controller = make_tpu_controller(pk, self.cluster, self.state, self.clock,
                                              self.scheduler)
        self.controller.start_watching()

    def submit(self, name, ns, resources, priority=0):
        pk = self.pk
        pod = pk.Pod(
            metadata=pk.ObjectMeta(name=name, namespace=ns),
            spec=pk.PodSpec(
                containers=[pk.Container(resources=pk.ResourceList.of(resources))],
                scheduler_name=pk.constants.SCHEDULER_NAME,
                priority=priority,
            ),
        )
        self.cluster.create(pod)
        return pod

    def tick(self, seconds=11.0):
        self.scheduler.schedule_pending()
        self.clock.advance(seconds)
        self.controller.process_batch_if_ready()
        return self.scheduler.schedule_pending()


def make_tpu_controller(pk, cluster, state, clock, scheduler):
    return pk.PartitionerController(
        cluster=cluster,
        state=state,
        kind=pk.constants.KIND_TPU,
        snapshot_taker=pk.TpuSnapshotTaker(),
        partitioner=pk.TpuPartitioner(cluster),
        sim_scheduler=pk.SchedulerSim(scheduler),
        now=clock,
    )


def build_plane(pk):
    """test_multihost.py's `build_plane`: the package's `ControlPlane` on a
    fake clock (kept as `plane.clock`)."""
    clock = FakeClock()
    plane = pk.ControlPlane(now=clock).start()
    plane.clock = clock
    return plane


def make_group(pk, plane, slice_id="s0", global_topo="8x8", host_topo="2x2", grid=(4, 4)):
    """Create a slice group: grid[0] x grid[1] hosts of host_topo chips."""
    names = []
    for r in range(grid[0]):
        for c in range(grid[1]):
            name = f"{slice_id}-host-{r}-{c}"
            plane.cluster.create(
                pk.Node(
                    metadata=pk.ObjectMeta(
                        name=name,
                        labels={
                            pk.constants.LABEL_PARTITIONING: pk.constants.KIND_TPU_MULTIHOST,
                            pk.constants.LABEL_TPU_SLICE: slice_id,
                            pk.constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                            pk.constants.LABEL_TPU_TOPOLOGY: global_topo,
                            pk.constants.LABEL_TPU_HOST_TOPOLOGY: host_topo,
                            pk.constants.LABEL_TPU_HOST_COORD: f"{r},{c}",
                        },
                    ),
                    status=pk.NodeStatus(
                        allocatable=pk.ResourceList.of(
                            {"cpu": 32, "memory": "64Gi", "google.com/tpu": 4}
                        )
                    ),
                )
            )
            plane.add_host_agent(name)
            names.append(name)
    return names


def submit_gang(pk, plane, name, ns, topology, size, priority=0):
    pods = []
    for i in range(size):
        pod = pk.Pod(
            metadata=pk.ObjectMeta(
                name=f"{name}-{i}",
                namespace=ns,
                labels={
                    pk.constants.LABEL_GANG: name,
                    pk.constants.LABEL_GANG_SIZE: str(size),
                },
            ),
            spec=pk.PodSpec(
                containers=[
                    pk.Container(resources=pk.ResourceList.of({"google.com/tpu": 4, "cpu": 1}))
                ],
                scheduler_name=pk.constants.SCHEDULER_NAME,
                priority=priority,
                node_selector={pk.constants.LABEL_TPU_SUBSLICE_TOPOLOGY: topology},
            ),
        )
        plane.cluster.create(pod)
        pods.append(pod)
    return pods


def tick(plane, clock, dt=61.0):
    plane.scheduler.schedule_pending()
    clock.t += dt
    plane.group_partitioner.process_batch_if_ready()
    return plane.scheduler.schedule_pending()


def gang_nodes(plane, ns, name, size):
    out = []
    for i in range(size):
        pod = plane.cluster.get("Pod", ns, f"{name}-{i}")
        out.append((pod.spec.node_name, pod.status.phase))
    return out


def test_partitioner_restart_is_stateless(pk):
    """A fresh PartitionerController over the same cluster neither re-plans
    (spec already matches status) nor disturbs the bound pod."""
    sys = System(pk)
    sys.submit("job", "ml", {"google.com/tpu-2x2": 1})
    sys.tick()
    node_before = sys.cluster.get("Node", "", "tpu-node-0")
    plan_before = node_before.metadata.annotations[pk.constants.ANNOTATION_SPEC_PLAN]

    # "Restart": new mirror + controller from the live cluster only.
    state2 = pk.ClusterState()
    state2.start_watching(sys.cluster)
    ctrl2 = make_tpu_controller(pk, sys.cluster, state2, sys.clock, sys.scheduler)
    ctrl2.start_watching()
    sys.clock.advance(61)
    ctrl2.process_batch_if_ready()
    node_after = sys.cluster.get("Node", "", "tpu-node-0")
    assert node_after.metadata.annotations[pk.constants.ANNOTATION_SPEC_PLAN] == plan_before
    pod = sys.cluster.get("Pod", "ml", "job")
    assert pod.status.phase == pk.PodPhase.RUNNING


def test_agent_restart_preserves_used_cleans_free(pk):
    """Agent crash + restart: startup deletes slices not in use (crash-safe
    re-sync, cmd/migagent/migagent.go:190-199 analog) and re-acks the
    standing spec so the plan handshake resumes."""
    sys = System(pk)
    sys.submit("keep", "ml", {"google.com/tpu-2x2": 1})
    sys.tick()
    agent = sys.agents["tpu-node-0"]
    # Carve an extra free slice directly on the device layer (as if a crash
    # left an orphan).
    agent.client.create_slice(pk.Profile.parse("1x1"), (3, 3), (1, 1))
    assert len(agent.client.list_slices()) == 2

    agent2 = pk.TpuAgent(sys.cluster, "tpu-node-0", agent.client)
    agent2.startup()
    slices = agent2.client.list_slices()
    assert len(slices) == 1  # orphan free slice cleaned, used slice kept
    assert slices[0].in_use
    node = sys.cluster.get("Node", "", "tpu-node-0")
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)
    pod = sys.cluster.get("Pod", "ml", "keep")
    assert pod.status.phase == pk.PodPhase.RUNNING


def test_host_agent_restart_reacks_assignment(pk):
    plane = build_plane(pk)
    clock = plane.clock
    names = make_group(pk, plane)
    submit_gang(pk, plane, "g", "ml", "4x8", size=8)
    tick(plane, clock)
    hosts = {n for n, _ in gang_nodes(plane, "ml", "g", 8)}
    victim = sorted(hosts)[0]
    # Simulate losing the ack state: strip status annotations + labels.
    def wipe(n):
        n.metadata.annotations.pop(pk.constants.ANNOTATION_STATUS_SUBSLICE_ID, None)
        n.metadata.annotations.pop(pk.constants.ANNOTATION_STATUS_PLAN, None)
        n.metadata.labels.pop(pk.constants.LABEL_TPU_SUBSLICE_ID, None)

    plane.cluster.patch("Node", "", victim, wipe)
    agent2 = pk.HostAgent(plane.cluster, victim)
    agent2.startup()
    node = plane.cluster.get("Node", "", victim)
    assert pk.constants.LABEL_TPU_SUBSLICE_ID in node.metadata.labels
    assert pk.ann.node_reported_last_plan(node.metadata.annotations)


def test_group_partitioner_restart_is_stateless(pk):
    plane = build_plane(pk)
    clock = plane.clock
    make_group(pk, plane)
    submit_gang(pk, plane, "g", "ml", "4x8", size=8)
    tick(plane, clock)
    plans_before = {
        n.metadata.name: n.metadata.annotations.get(pk.constants.ANNOTATION_SPEC_PLAN)
        for n in plane.cluster.list("Node")
    }
    gp2 = pk.GroupPartitioner(plane.cluster, now=clock)
    gp2.start_watching()
    clock.t += 61
    gp2.process_batch_if_ready()
    plans_after = {
        n.metadata.name: n.metadata.annotations.get(pk.constants.ANNOTATION_SPEC_PLAN)
        for n in plane.cluster.list("Node")
    }
    assert plans_before == plans_after
    assert all(
        phase == pk.PodPhase.RUNNING for _, phase in gang_nodes(plane, "ml", "g", 8)
    )


# -- across packages ----------------------------------------------------------
def without_plan_ids(pk, mapping):
    ids = (pk.constants.ANNOTATION_SPEC_PLAN, pk.constants.ANNOTATION_STATUS_PLAN)
    return {k: v for k, v in mapping.items() if k not in ids}


def group_outcome(pk, cluster):
    """Per node: annotations without plan ids, and labels; per pod: its
    node and phase."""
    nodes = {n.metadata.name: (without_plan_ids(pk, n.metadata.annotations),
                               dict(n.metadata.labels))
             for n in cluster.list("Node")}
    pods = {p.metadata.namespaced_name: (p.spec.node_name, p.status.phase.value
                                         if hasattr(p.status.phase, "value") else p.status.phase)
            for p in cluster.list("Pod")}
    return nodes, pods


def group_restart_run(pk, plane):
    """test_group_partitioner_restart_is_stateless's scenario plus a second
    gang after the restart: the outcome after the first round, after the
    restart's round, and after the second gang's round."""
    clock = plane.clock
    make_group(pk, plane)
    submit_gang(pk, plane, "g", "ml", "4x8", size=8)
    tick(plane, clock)
    before = group_outcome(pk, plane.cluster)
    plane.group_partitioner.stop()
    gp2 = pk.GroupPartitioner(plane.cluster, now=clock)
    gp2.start_watching()
    plane.group_partitioner = gp2
    clock.t += 61
    gp2.process_batch_if_ready()
    after = group_outcome(pk, plane.cluster)
    submit_gang(pk, plane, "h", "ml", "2x4", size=2)
    tick(plane, clock)
    return before, after, group_outcome(pk, plane.cluster)


def test_group_carve_equal_across_packages_and_to_control_plane():
    """`GroupPartitioner` and `HostAgent`s on test_fault_recovery.py's
    group, each package through its own `ControlPlane` (its scheduler
    binding): both carve, ack and bind alike before and after a partitioner
    restart."""
    ref = group_restart_run(REF, build_plane(REF))
    port = group_restart_run(PORT, build_plane(PORT))
    assert port == ref

    before, after, last = ref
    assert before == after
    assert sum(1 for node, phase in last[1].values() if node and phase == "Running") == 10
    subslices = {labels.get(REF.constants.LABEL_TPU_SUBSLICE_ID) for _, labels in last[0].values()}
    assert len(subslices - {None}) >= 2


def quota_churn(pk, seed, steps=60):
    """ElasticQuotas (and one composite) over four namespaces, then a seeded
    churn of pods created, finished and deleted; returns each quota's
    `used` and every pod's capacity label after each step."""
    cluster = pk.Cluster()
    pk.install_quota_webhooks(cluster)
    reconciler = pk.QuotaReconciler(cluster)
    reconciler.start_watching()
    cluster.create(pk.build_eq("ns-a", "qa", min={"cpu": 4, pk.constants.RESOURCE_TPU: 8,
                                                pk.constants.RESOURCE_ACCELERATOR_MEMORY: 64}))
    cluster.create(pk.build_eq("ns-b", "qb", min={"cpu": 2}, max={"cpu": 16}))
    cluster.create(pk.build_composite_eq("team", ["ns-c", "ns-d"], min={
        "cpu": 6, pk.constants.RESOURCE_ACCELERATOR_MEMORY: 80}))
    rng = random.Random(seed)
    resources = [{"cpu": 1}, {"cpu": 2}, {"cpu": 0.5, pk.constants.RESOURCE_TPU: 4},
                 {"cpu": 1, "google.com/tpu-2x2": 1}, {"cpu": 1, "nvidia.com/mig-1g.5gb": 1},
                 {"cpu": 1, "nvidia.com/gpu-10gb": 1}]
    live, trace = [], []
    for step in range(steps):
        roll = rng.random()
        if roll < 0.6 or not live:
            ns = rng.choice(["ns-a", "ns-b", "ns-c", "ns-d"])
            pod = pk.Pod(
                metadata=pk.ObjectMeta(name=f"p{step}", namespace=ns,
                                       creation_timestamp=float(step)),
                spec=pk.PodSpec(
                    containers=[pk.Container(resources=pk.ResourceList.of(rng.choice(resources)))],
                    priority=rng.choice([0, 0, 5]),
                    node_name="n1",
                ),
                status=pk.PodStatus(phase=pk.PodPhase.RUNNING),
            )
            cluster.create(pod)
            live.append((ns, pod.metadata.name))
        elif roll < 0.85:
            ns, name = live.pop(rng.randrange(len(live)))
            cluster.patch("Pod", ns, name, lambda p: setattr(p.status, "phase", pk.PodPhase.SUCCEEDED))
        else:
            ns, name = live.pop(rng.randrange(len(live)))
            cluster.delete("Pod", ns, name)
        used = {(kind, q.metadata.namespace, q.metadata.name): dict(q.status.used)
                for kind in ("ElasticQuota", "CompositeElasticQuota") for q in cluster.list(kind)}
        labels = {p.metadata.namespaced_name: p.metadata.labels.get(pk.constants.LABEL_CAPACITY)
                  for p in cluster.list("Pod")}
        trace.append((used, labels))
    reconciler.stop()
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quota_reconciler_equal_across_packages(seed):
    ref = quota_churn(REF, seed)
    assert quota_churn(PORT, seed) == ref
    labels = {v for _, step in ref for v in step.values()}
    assert {REF.constants.CAPACITY_IN_QUOTA, REF.constants.CAPACITY_OVER_QUOTA} <= labels
    used = ref[-1][0]
    assert any(REF.constants.RESOURCE_ACCELERATOR_MEMORY in u for u in used.values())
