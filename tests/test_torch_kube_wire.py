"""The port's Kubernetes backend (`nos_tpu_torch/cluster/kube.py`) and API
server emulator (`cluster/apiserver.py`) against the JAX package's.

- The cases of tests/test_kube_wire_fixtures.py on both packages: the
  client against a scripted raw-socket server that plays responses copied
  from the Kubernetes API reference (its `ScriptedServer` and wire bodies
  are reused), and the emulator's responses to raw HTTP requests.
- Across packages: each package's `KubeCluster` against each package's
  `ClusterAPIServer` drives one scenario (create, get, list, merge-patch
  with a null that deletes, the status subresource, a conflict, a watch,
  delete); all four pairings give the reference pair's results and watch
  events, with the values a server assigns (uid, resourceVersion,
  creationTimestamp) masked.

Every server binds port 0 on 127.0.0.1 and stops in a finalizer; every
wait has a deadline, and each test a limit (SIGALRM)."""

from __future__ import annotations

import http.client
import importlib
import json
import types

import pytest

import test_torch_fleet_parity as fp
from test_kube_wire_fixtures import (ScriptedServer, is_pod_list, is_pod_watch, pod_list_body,
                                     pod_wire, status_body, wait_for)

PACKAGES = ("nos_tpu", "nos_tpu_torch")

_time_limit = fp.time_limit(60)


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.o = importlib.import_module(f"{pkg}.api.objects")
    m.r = importlib.import_module(f"{pkg}.api.resources")
    m.q = importlib.import_module(f"{pkg}.api.quota_types")
    m.c = importlib.import_module(f"{pkg}.cluster.client")
    m.s = importlib.import_module(f"{pkg}.cluster.serialize")
    m.kube = importlib.import_module(f"{pkg}.cluster.kube")
    m.api = importlib.import_module(f"{pkg}.cluster.apiserver")
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


@pytest.fixture()
def scripted():
    servers = []

    def make():
        servers.append(ScriptedServer())
        return servers[-1]

    yield make
    for s in servers:
        s.stop()


def kube_of(p, url, opened):
    kube = p.kube.KubeCluster(p.kube.KubeConfig(server=url))
    opened.append(kube)
    return kube


@pytest.fixture()
def clients():
    opened = []
    yield opened
    for k in opened:
        k.close()


# -- client fixtures ----------------------------------------------------------
def test_quantities_and_listless_kind_parse(p, scripted, clients):
    """Real LIST bodies: items without kind/apiVersion, m/Gi quantity
    spellings, opaque string resourceVersions, RFC3339 timestamps."""
    srv = scripted().on(
        "GET", is_pod_list,
        ("respond", 200, pod_list_body(500, pod_wire("a", 7, with_kind=False))),
    )
    pods = kube_of(p, srv.url, clients).list("Pod")
    assert len(pods) == 1
    res = pods[0].spec.containers[0].resources
    assert res["cpu"] == pytest.approx(0.1)  # "100m"
    assert res["memory"] == pytest.approx(2**30)  # "1Gi"
    assert pods[0].metadata.uid == "u-1"
    assert pods[0].metadata.creation_timestamp > 0


def test_watch_bookmark_and_410_recovery(p, scripted, clients):
    """BOOKMARK frames are ignored, an ERROR frame with a 410 `Status`
    forces a re-list, and the re-list synthesizes the missed deltas."""
    EventType = p.c.EventType
    bookmark = {"type": "BOOKMARK", "object": {
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"resourceVersion": "520", "creationTimestamp": None}}}
    gone = {"type": "ERROR", "object": {
        "kind": "Status", "apiVersion": "v1", "metadata": {}, "status": "Failure",
        "message": "too old resource version: 500 (611)", "reason": "Expired", "code": 410}}
    srv = (
        scripted()
        .on("GET", is_pod_list,
            ("respond", 200, pod_list_body(500)),
            ("respond", 200, pod_list_body(
                611, pod_wire("a", 600, phase="Succeeded", with_kind=False),
                pod_wire("b", 610, with_kind=False, uid="u-2"))))
        .on("GET", is_pod_watch,
            ("stream", [json.dumps({"type": "ADDED", "object": pod_wire("a", 7)}),
                        json.dumps(bookmark), json.dumps(gone)], False),
            ("stream", [], True))
    )
    events = []
    kube_of(p, srv.url, clients).watch("Pod", events.append)
    wait_for(lambda: any(e.type == EventType.ADDED and e.obj.metadata.name == "a"
                         for e in events), msg="ADDED from the stream")
    assert all(e.obj.metadata.name in ("a", "b") for e in events)
    wait_for(lambda: any(e.type == EventType.MODIFIED and e.obj.metadata.name == "a"
                         and e.obj.status.phase == "Succeeded" for e in events),
             msg="MODIFIED synthesized from post-410 re-list")
    wait_for(lambda: any(e.type == EventType.ADDED and e.obj.metadata.name == "b"
                         for e in events), msg="missed ADD synthesized from post-410 re-list")


def test_watch_drop_mid_stream_reconnects(p, scripted, clients):
    """A watch dying mid-stream (EOF, no ERROR frame) re-lists and resumes."""
    srv = (
        scripted()
        .on("GET", is_pod_list,
            ("respond", 200, pod_list_body(500, pod_wire("a", 7, with_kind=False))),
            ("respond", 200, pod_list_body(600, pod_wire("a", 7, with_kind=False),
                                           pod_wire("c", 590, with_kind=False, uid="u-3"))))
        .on("GET", is_pod_watch, ("stream", [], False), ("stream", [], True))
    )
    events = []
    kube_of(p, srv.url, clients).watch("Pod", events.append)
    wait_for(lambda: any(e.type == p.c.EventType.ADDED and e.obj.metadata.name == "c"
                         for e in events), msg="delta synthesized after mid-stream drop")


def _is_pod_x(path):
    return path.startswith("/api/v1/namespaces/default/pods/x")


def test_conflict_storm_then_success(p, scripted, clients):
    """409 `Status` bodies with reason=Conflict drive the OCC retry loop:
    re-GET, re-apply, re-PATCH, each main patch echoing its resourceVersion."""
    conflict = status_body(409, "Conflict", 'Operation cannot be fulfilled on pods "x": '
                           "the object has been modified")
    srv = scripted()
    for rv in (10, 11, 12):
        srv.on("GET", _is_pod_x, ("respond", 200, json.dumps(pod_wire("x", rv)).encode()))
    srv.on("PATCH", _is_pod_x, ("respond", 409, conflict), ("respond", 409, conflict),
           ("respond", 200, json.dumps(pod_wire("x", 13, phase="Succeeded")).encode()))
    got = kube_of(p, srv.url, clients).patch(
        "Pod", "default", "x", lambda x: setattr(x.status, "phase", "Succeeded"))
    assert got.status.phase == "Succeeded"
    patches = srv.seen("PATCH", _is_pod_x)
    assert len(patches) == 3
    for ex in patches:
        assert ex.headers["content-type"] == "application/merge-patch+json"
    bodies = [json.loads(ex.body) for ex in patches]
    assert all(b.get("metadata", {}).get("resourceVersion") for b in bodies if "status" not in b)


def test_conflict_storm_exhausts_retries(p, scripted, clients):
    conflict = status_body(409, "Conflict", "the object has been modified")
    srv = scripted()
    for rv in range(10, 20):
        srv.on("GET", _is_pod_x, ("respond", 200, json.dumps(pod_wire("x", rv)).encode()))
    for _ in range(8):
        srv.on("PATCH", _is_pod_x, ("respond", 409, conflict))
    with pytest.raises(p.c.ConflictError):
        kube_of(p, srv.url, clients).patch(
            "Pod", "default", "x", lambda x: setattr(x.status, "phase", "Succeeded"))
    assert len(srv.seen("PATCH", _is_pod_x)) == 5  # bounded OCC retries


def test_merge_patch_null_deletes_annotation_on_wire(p, scripted, clients):
    """RFC 7386: removing an annotation is sent as an explicit JSON null."""
    wire = pod_wire("x", 10)
    wire["metadata"]["annotations"] = {"keep": "1", "drop": "2"}
    out = pod_wire("x", 11)
    out["metadata"]["annotations"] = {"keep": "1"}
    srv = (scripted().on("GET", _is_pod_x, ("respond", 200, json.dumps(wire).encode()))
           .on("PATCH", _is_pod_x, ("respond", 200, json.dumps(out).encode())))
    kube_of(p, srv.url, clients).patch(
        "Pod", "default", "x", lambda x: x.metadata.annotations.pop("drop"))
    (ex,) = srv.seen("PATCH", _is_pod_x)
    assert json.loads(ex.body)["metadata"]["annotations"] == {"drop": None}


def test_dead_keepalive_get_retries_once(p, scripted, clients):
    """A GET whose keep-alive connection dies is retried once, fresh."""
    srv = scripted().on(
        "GET", _is_pod_x,
        ("respond", 200, json.dumps(pod_wire("x", 10)).encode()),
        ("close",),
        ("respond", 200, json.dumps(pod_wire("x", 11)).encode()),
    )
    kube = kube_of(p, srv.url, clients)
    kube.get("Pod", "default", "x")  # warm the keep-alive
    assert str(kube.get("Pod", "default", "x").metadata.resource_version) == "11"
    assert len(srv.seen("GET", _is_pod_x)) == 3


def test_dead_keepalive_non_idempotent_not_resent(p, scripted, clients):
    """A POST that died after being sent surfaces, never re-sent."""
    def is_pods(path):
        return path.startswith("/api/v1/namespaces/default/pods")

    srv = (scripted().on("GET", is_pods, ("respond", 200, json.dumps(pod_wire("w", 9)).encode()))
           .on("POST", is_pods, ("close",)))
    kube = kube_of(p, srv.url, clients)
    kube.get("Pod", "default", "w")  # warm the keep-alive
    with pytest.raises(Exception) as err:
        kube.create(p.o.Pod(metadata=p.o.ObjectMeta(name="x", namespace="default"),
                            spec=p.o.PodSpec()))
    assert not isinstance(err.value, (p.c.NotFoundError, p.c.ConflictError))
    assert len(srv.seen("POST", is_pods)) == 1  # never re-sent


# -- emulator-vs-spec fixtures ------------------------------------------------
# One emulator a package for the module: each case writes its own namespace.
@pytest.fixture(scope="module", params=PACKAGES)
def emulator(request):
    p = load(request.param)
    backing = p.c.Cluster()
    server = p.api.ClusterAPIServer(backing).start()
    request.addfinalizer(server.stop)
    return p, backing, server


@pytest.fixture()
def raw(emulator):
    p, backing, server = emulator
    conn = http.client.HTTPConnection("127.0.0.1", server._httpd.server_address[1], timeout=10)
    yield p, backing, conn
    conn.close()


def _req(conn, method, path, body=None, ctype="application/json"):
    headers = {"Content-Type": ctype} if body is not None else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, json.loads(data) if data else {}


def test_error_bodies_are_status_objects(raw):
    _, _, conn = raw
    status, body = _req(conn, "GET", "/api/v1/namespaces/errors/pods/nope")
    assert status == 404
    assert body["kind"] == "Status" and body["apiVersion"] == "v1"
    assert body["status"] == "Failure" and body["reason"] == "NotFound"
    assert body["code"] == 404


def test_conflict_body_shape(raw):
    p, backing, conn = raw
    backing.create(p.o.Pod(metadata=p.o.ObjectMeta(name="x", namespace="conflict")))
    cur = backing.get("Pod", "conflict", "x")
    patch = {"metadata": {"resourceVersion": str(cur.metadata.resource_version + 99)},
             "spec": {"nodeName": "h"}}
    status, body = _req(conn, "PATCH", "/api/v1/namespaces/conflict/pods/x",
                        body=json.dumps(patch), ctype="application/merge-patch+json")
    assert status == 409
    assert body["kind"] == "Status" and body["reason"] == "Conflict"


def test_merge_patch_null_deletes(raw):
    p, backing, conn = raw
    backing.create(p.o.Pod(metadata=p.o.ObjectMeta(
        name="x", namespace="merge", annotations={"keep": "1", "drop": "2"})))
    status, body = _req(conn, "PATCH", "/api/v1/namespaces/merge/pods/x",
                        body=json.dumps({"metadata": {"annotations": {"drop": None}}}),
                        ctype="application/merge-patch+json")
    assert status == 200
    assert body["metadata"]["annotations"] == {"keep": "1"}
    assert backing.get("Pod", "merge", "x").metadata.annotations == {"keep": "1"}


def test_status_subresource_isolation(raw):
    p, backing, conn = raw
    backing.create(p.o.Pod(metadata=p.o.ObjectMeta(name="x", namespace="status")))
    # A main-resource patch carrying status must not change status.
    status, _ = _req(conn, "PATCH", "/api/v1/namespaces/status/pods/x",
                     body=json.dumps({"status": {"phase": "Succeeded"}, "metadata": {}}),
                     ctype="application/merge-patch+json")
    assert status == 200
    assert backing.get("Pod", "status", "x").status.phase == "Pending"
    status, _ = _req(conn, "PATCH", "/api/v1/namespaces/status/pods/x/status",
                     body=json.dumps({"status": {"phase": "Succeeded"}}),
                     ctype="application/merge-patch+json")
    assert status == 200
    assert backing.get("Pod", "status", "x").status.phase == "Succeeded"


def test_watch_frames_one_json_per_line(raw):
    p, backing, conn = raw
    conn.request("GET", "/api/v1/namespaces/watch/pods?watch=true&resourceVersion=0")
    resp = conn.getresponse()
    assert resp.status == 200
    backing.create(p.o.Pod(metadata=p.o.ObjectMeta(name="x", namespace="watch")))
    frame = json.loads(resp.readline())  # transfer-decoded (chunked) line
    assert frame["type"] == "ADDED"
    obj = frame["object"]
    assert obj["kind"] == "Pod" and obj["apiVersion"] == "v1"
    assert obj["metadata"]["resourceVersion"]


# -- across packages ----------------------------------------------------------
ASSIGNED = ("uid", "resourceVersion", "creationTimestamp")


def masked(p, obj):
    """`obj`'s wire dict without the values its server assigned."""
    wire = p.s.to_wire(obj)
    for key in ASSIGNED:
        wire.get("metadata", {}).pop(key, None)
    return wire


def scenario(client_pkg, server_pkg):
    """`client_pkg`'s KubeCluster against `server_pkg`'s ClusterAPIServer.
    -> the results and watch events, server-assigned values masked."""
    p, srv_p = load(client_pkg), load(server_pkg)
    server = srv_p.api.ClusterAPIServer().start()
    kube = p.kube.KubeCluster(p.kube.KubeConfig(server=server.url))
    out = {}
    events = []
    try:
        kube.watch("Pod", events.append)
        node = p.o.Node(metadata=p.o.ObjectMeta(name="host-0", labels={"pool": "a"}),
                        status=p.o.NodeStatus(allocatable=p.r.ResourceList.of(
                            {"google.com/tpu": 4, "cpu": 8})))
        out["node"] = masked(p, kube.create(node))
        pod = p.o.Pod(metadata=p.o.ObjectMeta(name="w0", namespace="team-a",
                                              annotations={"keep": "1", "drop": "2"}),
                      spec=p.o.PodSpec(containers=[p.o.Container(
                          resources=p.r.ResourceList.of({"google.com/tpu": 2, "cpu": "500m"}))]))
        out["create"] = masked(p, kube.create(pod))
        kube.create(p.o.Pod(metadata=p.o.ObjectMeta(name="w1", namespace="team-b")))
        quota = p.q.ElasticQuota(metadata=p.o.ObjectMeta(name="eq", namespace="team-a"),
                                 spec=p.q.ElasticQuotaSpec(
                                     min=p.r.ResourceList.of({"google.com/tpu": 2})))
        out["quota"] = masked(p, kube.create(quota))
        out["get"] = masked(p, kube.get("Pod", "team-a", "w0"))
        out["list"] = [(x.metadata.namespace, x.metadata.name) for x in kube.list("Pod")]
        out["list_ns"] = [x.metadata.name for x in kube.list("Pod", namespace="team-b")]
        out["patch_null"] = masked(p, kube.patch(
            "Pod", "team-a", "w0", lambda x: x.metadata.annotations.pop("drop")))
        out["patch_status"] = masked(p, kube.patch(
            "Pod", "team-a", "w0", lambda x: setattr(x.status, "phase", "Running")))
        stale = kube.get("Pod", "team-a", "w0")
        fresh = kube.get("Pod", "team-a", "w0")
        fresh.metadata.labels["rev"] = "2"
        kube.update(fresh)
        stale.metadata.labels["rev"] = "stale"
        try:
            kube.update(stale)
            out["conflict"] = None
        except p.c.ConflictError:
            out["conflict"] = "ConflictError"
        out["after_conflict"] = masked(p, kube.get("Pod", "team-a", "w0"))
        kube.delete("Pod", "team-b", "w1")
        out["missing"] = kube.try_get("Pod", "team-b", "w1")
        wait_for(lambda: any(e.type == p.c.EventType.DELETED for e in events),
                 msg="the DELETED event")
        out["events"] = [(e.type, masked(p, e.obj)) for e in events]
    finally:
        kube.close()
        server.stop()
    return out


@pytest.fixture(scope="module")
def reference_scenario():
    return scenario("nos_tpu", "nos_tpu")


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("nos_tpu_torch", "nos_tpu"), ("nos_tpu", "nos_tpu_torch"),
    ("nos_tpu_torch", "nos_tpu_torch")])
def test_kube_client_and_emulator_across_packages(reference_scenario, client_pkg, server_pkg):
    got = scenario(client_pkg, server_pkg)
    want = reference_scenario
    assert want["conflict"] == "ConflictError" and want["missing"] is None
    assert want["patch_null"]["metadata"]["annotations"] == {"keep": "1"}
    assert want["patch_status"]["status"]["phase"] == "Running"
    assert [t for t, _ in want["events"]] == ["ADDED", "ADDED", "MODIFIED", "MODIFIED",
                                              "MODIFIED", "DELETED"]
    assert got == want
