"""The port's in-memory cluster bus (`nos_tpu_torch/cluster/client.py`)
against the JAX package's: the cases of tests/test_cluster.py (CRUD, value
semantics, optimistic concurrency, watch, webhooks), each run on both
packages, and telemetry's cluster half (`collect`, `export`) over the same
cluster contents, equal across packages."""

import dataclasses
import importlib
import json
import types

import pytest

PACKAGES = ("nos_tpu", "nos_tpu_torch")


def load(pkg):
    """The package's control-plane modules these cases use."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    client = importlib.import_module(f"{pkg}.cluster.client")
    return types.SimpleNamespace(pkg=pkg, o=objects, c=client)


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


def make_pod(p, name, ns="default", phase=None):
    pod = p.o.Pod(metadata=p.o.ObjectMeta(name=name, namespace=ns))
    pod.status.phase = p.o.PodPhase.PENDING if phase is None else phase
    return pod


def test_create_get_roundtrip_with_value_semantics(p):
    c = p.c.Cluster()
    pod = make_pod(p, "a")
    c.create(pod)
    pod.metadata.labels["mutated-after-create"] = "yes"  # must not leak into store
    got = c.get("Pod", "default", "a")
    assert got.metadata.name == "a"
    assert "mutated-after-create" not in got.metadata.labels
    got.metadata.labels["mutated-after-read"] = "yes"  # must not leak either
    assert "mutated-after-read" not in c.get("Pod", "default", "a").metadata.labels


def test_create_duplicate_and_get_missing(p):
    c = p.c.Cluster()
    c.create(make_pod(p, "a"))
    with pytest.raises(p.c.AlreadyExistsError):
        c.create(make_pod(p, "a"))
    with pytest.raises(p.c.NotFoundError):
        c.get("Pod", "default", "nope")
    assert c.try_get("Pod", "default", "nope") is None


def test_update_optimistic_concurrency(p):
    c = p.c.Cluster()
    stored = c.create(make_pod(p, "a"))
    stale = c.get("Pod", "default", "a")
    stored.status.phase = p.o.PodPhase.RUNNING
    c.update(stored)
    stale.status.phase = p.o.PodPhase.FAILED
    with pytest.raises(p.c.ConflictError):
        c.update(stale)
    assert c.get("Pod", "default", "a").status.phase == p.o.PodPhase.RUNNING


def test_patch_read_modify_write(p):
    c = p.c.Cluster()
    c.create(make_pod(p, "a"))

    def set_label(pod):
        pod.metadata.labels["k"] = "v"

    c.patch("Pod", "default", "a", set_label)
    assert c.get("Pod", "default", "a").metadata.labels["k"] == "v"


def test_list_filters(p):
    c = p.c.Cluster()
    c.create(make_pod(p, "a", ns="ns1"))
    c.create(make_pod(p, "b", ns="ns2"))
    running = make_pod(p, "c", ns="ns1", phase=p.o.PodPhase.RUNNING)
    running.metadata.labels["app"] = "x"
    c.create(running)
    c.create(p.o.Node(metadata=p.o.ObjectMeta(name="n1")))

    assert [x.metadata.name for x in c.list("Pod")] == ["a", "c", "b"]
    assert [x.metadata.name for x in c.list("Pod", namespace="ns1")] == ["a", "c"]
    assert [x.metadata.name for x in c.list("Pod", label_selector={"app": "x"})] == ["c"]
    assert [
        x.metadata.name
        for x in c.list("Pod", predicate=lambda x: x.status.phase == p.o.PodPhase.PENDING)
    ] == ["a", "b"]
    assert [n.metadata.name for n in c.list("Node")] == ["n1"]


def test_watch_replay_and_live_events(p):
    EventType = p.c.EventType
    c = p.c.Cluster()
    c.create(make_pod(p, "pre"))
    events = []
    unsub = c.watch("Pod", events.append)
    assert [(e.type, e.obj.metadata.name) for e in events] == [(EventType.ADDED, "pre")]

    c.create(make_pod(p, "live"))
    c.patch("Pod", "default", "live", lambda x: x.metadata.labels.update(x="1"))
    c.delete("Pod", "default", "live")
    types_ = [(e.type, e.obj.metadata.name) for e in events[1:]]
    assert types_ == [
        (EventType.ADDED, "live"),
        (EventType.MODIFIED, "live"),
        (EventType.DELETED, "live"),
    ]
    # MODIFIED events carry the old object for predicate diffing.
    assert events[2].old_obj is not None and "x" not in events[2].old_obj.metadata.labels

    unsub()
    c.create(make_pod(p, "after-unsub"))
    assert len(events) == 4


def test_admission_webhook_rejects(p):
    c = p.c.Cluster()

    def deny_ns(op, obj, old):
        if obj.metadata.namespace == "forbidden":
            raise p.c.AdmissionError("nope")

    c.register_webhook("Pod", deny_ns)
    c.create(make_pod(p, "ok"))
    with pytest.raises(p.c.AdmissionError):
        c.create(make_pod(p, "bad", ns="forbidden"))
    assert c.try_get("Pod", "forbidden", "bad") is None


def populate(pkg):
    """One cluster of `pkg` with TPU, GPU and plain nodes, partitioning
    modes, and quotas: the contents telemetry counts."""
    constants = importlib.import_module(f"{pkg}.constants")
    o = importlib.import_module(f"{pkg}.api.objects")
    q = importlib.import_module(f"{pkg}.api.quota_types")
    ResourceList = importlib.import_module(f"{pkg}.api.resources").ResourceList
    c = importlib.import_module(f"{pkg}.cluster.client").Cluster()
    for i, (chips, mode) in enumerate([(16, constants.KIND_TPU), (4, constants.KIND_TPU),
                                       (8, constants.KIND_TPU_MULTIHOST)]):
        c.create(o.Node(
            metadata=o.ObjectMeta(name=f"tpu-{i}", labels={
                constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                constants.LABEL_TPU_TOPOLOGY: "4x4",
                constants.LABEL_PARTITIONING: mode}),
            status=o.NodeStatus(allocatable=ResourceList.of({constants.RESOURCE_TPU: chips}))))
    c.create(o.Node(metadata=o.ObjectMeta(name="gpu-0", labels={
        constants.LABEL_GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
        constants.LABEL_PARTITIONING: constants.KIND_MIG})))
    c.create(o.Node(metadata=o.ObjectMeta(name="cpu-0")))
    for ns in ("team-a", "team-b"):
        c.create(q.ElasticQuota(
            metadata=o.ObjectMeta(name="eq", namespace=ns),
            spec=q.ElasticQuotaSpec(min=ResourceList.of({constants.RESOURCE_TPU: 4}))))
    c.create(q.CompositeElasticQuota(
        metadata=o.ObjectMeta(name="ceq", namespace="default"),
        spec=q.CompositeElasticQuotaSpec(namespaces=["team-c", "team-d"],
                                         min=ResourceList.of({constants.RESOURCE_TPU: 8}))))
    return c


def test_telemetry_collect_and_export_equal_across_packages():
    """`collect` over the same cluster contents gives equal reports, the
    version included; `export` ships the same payload when opted in and
    nothing when not."""
    from nos_tpu import telemetry as jt
    from nos_tpu_torch import telemetry as tt

    want = dataclasses.asdict(jt.collect(populate("nos_tpu")))
    got = dataclasses.asdict(tt.collect(populate("nos_tpu_torch")))
    assert got == want
    assert got["tpu_chips"] == 28 and got["node_count"] == 5
    assert got["partitioning_modes"] == {"tpu": 2, "tpu-multihost": 1, "mig": 1}
    sent = {}
    for pkg, mod in (("nos_tpu", jt), ("nos_tpu_torch", tt)):
        cluster = populate(pkg)
        assert mod.export(cluster) is None
        mod.export(cluster, share_telemetry=True, sink=lambda s, pkg=pkg: sent.__setitem__(pkg, s))
    assert sent["nos_tpu"] == sent["nos_tpu_torch"]
    assert json.loads(sent["nos_tpu_torch"]) == want
