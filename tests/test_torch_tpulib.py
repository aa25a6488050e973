"""The port's device-control seam (`nos_tpu_torch/tpulib/`) against the JAX
package's: the cases of tests/test_native_tpulib.py, test_cloud_tpulib.py
and test_local_tpulib.py that need nothing of `config.py` or `system.py`,
each run on both packages (the three cases gated on a real TPU skip on the
reference without one, and on the port whenever `local_chips_visible()` is
False, which holds on an H100 too; the five that drive a `TpuAgent` use
`controllers/tpu_agent.py` of the package under test); then the
port's own seams and cross-package checks: `native_pack` of both packages
and the port's Python packer equal on the same inputs, both shims loaded in
one process from their own files, importing the port's `tpulib` building
nothing, `load_library()` None when the build fails, each package's
`CloudTpuClient` against the other's `FakeCloudTpuServer`, and the port's
CUDA enumeration, probe and allocator statistics on stub records."""

import importlib
import itertools
import json
import random
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax
import pytest
import torch

import test_torch_fleet_parity as fp

PACKAGES = ("nos_tpu", "nos_tpu_torch")
REPO = Path(__file__).resolve().parent.parent

_time_limit = fp.time_limit(60)


def load(pkg):
    m = types.SimpleNamespace(pkg=pkg)
    m.tpu = importlib.import_module(f"{pkg}.tpu")
    m.packing = importlib.import_module(f"{pkg}.tpu.packing")
    m.tpulib = importlib.import_module(f"{pkg}.tpulib")
    m.interface = importlib.import_module(f"{pkg}.tpulib.interface")
    m.native = importlib.import_module(f"{pkg}.tpulib.native_client")
    m.cloud = importlib.import_module(f"{pkg}.tpulib.cloud")
    m.cloud_server = importlib.import_module(f"{pkg}.tpulib.cloud_server")
    m.local = importlib.import_module(f"{pkg}.tpulib.local")
    m.tpu_agent = importlib.import_module(f"{pkg}.controllers.tpu_agent")
    m.metrics = importlib.import_module(f"{pkg}.observability").metrics
    m.constants = importlib.import_module(f"{pkg}.constants")
    m.objects = importlib.import_module(f"{pkg}.api.objects")
    m.ResourceList = importlib.import_module(f"{pkg}.api.resources").ResourceList
    m.Cluster = importlib.import_module(f"{pkg}.cluster").Cluster
    m.P = m.tpu.Profile.parse
    m.T = m.tpu.Topology.parse
    return m


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


REF, PORT = load("nos_tpu"), load("nos_tpu_torch")


# -- test_native_tpulib.py ----------------------------------------------------
@pytest.fixture
def native(p):
    assert p.native.ensure_built(), "the tpuslice shim did not build"
    return p


def test_native_client_lifecycle(native):
    p = native
    TpuLibError = p.interface.TpuLibError
    client = p.native.NativeTpuClient(p.T("v5e", "4x4"))
    assert client.health() is None
    h = client.create_slice(p.P("2x2"), (0, 0), (2, 2))
    assert h.slice_id == "slice-1" and not h.in_use
    with pytest.raises(TpuLibError):
        client.create_slice(p.P("2x2"), (1, 1), (2, 2))
    with pytest.raises(TpuLibError):
        client.create_slice(p.P("2x2"), (3, 3), (2, 2))
    client.set_slice_in_use("slice-1", True)
    with pytest.raises(TpuLibError):
        client.delete_slice("slice-1")
    client.create_slice(p.P("1x2"), (2, 0), (1, 2))
    assert {s.slice_id for s in client.list_slices()} == {"slice-1", "slice-2"}
    assert client.delete_all_except([]) == ["slice-2"]
    assert [s.slice_id for s in client.list_slices()] == ["slice-1"]
    client.set_slice_in_use("slice-1", False)
    client.delete_slice("slice-1")
    assert client.list_slices() == []


def test_native_pack_matches_python_randomized(native):
    p = native
    random.seed(7)
    for topo_name, gen in [("4x4", "v5e"), ("8x8", "v5e"), ("2x2x4", "v4"), ("4x4x4", "v4")]:
        topo = p.T(gen, topo_name)
        menu = list(topo.allowed_profiles)
        for _ in range(200):
            geometry = {}
            for _ in range(random.randint(1, 5)):
                q = random.choice(menu)
                geometry[q] = geometry.get(q, 0) + random.randint(1, 3)
            py = p.tpu.pack(topo.shape, geometry)
            nat = p.native.native_pack(topo.shape.dims, [], geometry)
            if py is None:
                assert nat is None, (topo_name, geometry)
            else:
                assert nat == [(pl.origin, pl.dims) for pl in py], (topo_name, geometry)


def test_native_pack_into_matches_python_with_occupied(native):
    p = native
    mesh = p.tpu.Shape.parse("4x4")
    occupied = [((0, 0), (2, 2)), ((2, 2), (1, 1))]
    geometry = {p.P("1x2"): 2, p.P("2x2"): 1}
    py = p.packing.pack_into(mesh, occupied, geometry)
    assert py is not None
    assert p.native.native_pack(mesh.dims, occupied, geometry) == [(pl.origin, pl.dims) for pl in py]
    big = {p.P("2x4"): 2}
    assert p.packing.pack_into(mesh, occupied, big) is None
    assert p.native.native_pack(mesh.dims, occupied, big) is None


# -- test_cloud_tpulib.py -----------------------------------------------------
@pytest.fixture()
def server(p):
    srv = p.cloud_server.FakeCloudTpuServer()
    srv.base_url = srv.start()
    yield srv
    srv.stop()


def make_cloud(p, server, **kw):
    kw.setdefault("poll_interval_s", 0.01)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("provision_timeout_s", 10.0)
    return p.cloud.CloudTpuClient(
        p.T("v5e", "4x4"), project="proj-1", zone="us-central2-b", base_url=server.base_url,
        token_provider=lambda: "test-token", **kw,
    )


def test_create_emits_documented_queued_resource_shape(p, server):
    c = p.cloud
    make_cloud(p, server).create_slice(p.P("2x2"), (0, 2), (2, 2))
    create = next(r for r in server.requests if r["method"] == "POST")
    assert create["path"] == "/v2/projects/proj-1/locations/us-central2-b/queuedResources"
    qr_id = create["query"]["queuedResourceId"][0]
    assert qr_id.startswith("nos-2x2-0-2-")
    spec = create["body"]["tpu"]["nodeSpec"][0]
    assert spec["parent"] == "projects/proj-1/locations/us-central2-b"
    assert spec["nodeId"] == qr_id
    node = spec["node"]
    assert node["acceleratorType"] == "v5litepod-4"
    assert node["runtimeVersion"]
    assert node["labels"] == {c.LABEL_MANAGED: "true", c.LABEL_PROFILE: "2x2", c.LABEL_ORIGIN: "0-2",
                              c.LABEL_DIMS: "2-2", c.LABEL_IN_USE: "false"}


def test_client_parses_canonical_list_response(p):
    c = p.cloud
    ours = {c.LABEL_MANAGED: "true", c.LABEL_PROFILE: "2x2", c.LABEL_ORIGIN: "0-0",
            c.LABEL_DIMS: "2-2", c.LABEL_IN_USE: "true"}
    pages = [
        {"queuedResources": [
            {"name": "projects/p/locations/z/queuedResources/nos-2x2-0-0-1",
             "state": {"state": "ACTIVE"},
             "tpu": {"nodeSpec": [{"parent": "projects/p/locations/z", "nodeId": "nos-2x2-0-0-1",
                                   "node": {"acceleratorType": "v5litepod-4", "labels": ours}}]}},
            {"name": "projects/p/locations/z/queuedResources/someone-else",
             "state": {"state": "ACTIVE"}, "tpu": {"nodeSpec": [{"node": {"labels": {}}}]}},
        ], "nextPageToken": "1"},
        {"queuedResources": [
            {"name": "projects/p/locations/z/queuedResources/nos-1x1-3-3-9",
             "state": {"state": "FAILED"},
             "tpu": {"nodeSpec": [{"node": {"labels": {
                 c.LABEL_MANAGED: "true", c.LABEL_PROFILE: "1x1", c.LABEL_ORIGIN: "3-3",
                 c.LABEL_DIMS: "1-1"}}}]}},
        ]},
    ]
    client = c.CloudTpuClient(p.T("v5e", "4x4"), project="p", zone="z", base_url="http://unused",
                              token_provider=lambda: None)
    nodes_page = {"nodes": [{"name": "projects/p/locations/z/nodes/nos-2x2-0-0-1",
                             "labels": {c.LABEL_IN_USE: "false"}}]}
    calls = []

    def fake_request(method, path, params=None, body=None):
        calls.append((method, path, dict(params or {})))
        if path.endswith("/nodes"):
            return nodes_page
        return pages[int((params or {}).get("pageToken", 0))]

    client._request = fake_request
    handles = client.list_slices()
    assert len(handles) == 1
    h = handles[0]
    assert h.slice_id == "nos-2x2-0-0-1"
    assert h.profile == p.P("2x2")
    assert h.origin == (0, 0) and h.dims == (2, 2)
    assert h.in_use is False
    qr_calls = [x for x in calls if x[1].endswith("/queuedResources")]
    assert len(qr_calls) == 2 and qr_calls[1][2]["pageToken"] == "1"


def test_client_maps_documented_error_status(p):
    c = p.cloud
    raw = json.dumps({"error": {"code": 429, "message": "Quota exceeded for TPU v5e chips",
                                "status": "RESOURCE_EXHAUSTED"}}).encode()
    err = c.CloudTpuClient._to_error(429, raw)
    assert isinstance(err, c.QuotaExhaustedError)
    assert "Quota exceeded" in err.message
    err2 = c.CloudTpuClient._to_error(404, json.dumps(
        {"error": {"code": 404, "message": "not found", "status": "NOT_FOUND"}}).encode())
    assert isinstance(err2, c.CloudApiError) and not isinstance(err2, c.QuotaExhaustedError)


def test_fake_server_speaks_operation_shape(p, server):
    import http.client
    from urllib.parse import urlparse

    c = p.cloud
    make_cloud(p, server).create_slice(p.P("1x1"), (3, 3), (1, 1))
    u = urlparse(server.base_url)
    conn = http.client.HTTPConnection(u.hostname, u.port)
    body = json.dumps({"tpu": {"nodeSpec": [{
        "parent": "projects/proj-1/locations/us-central2-b", "nodeId": "nos-raw-1",
        "node": {"acceleratorType": "v5litepod-1",
                 "labels": {c.LABEL_MANAGED: "true", c.LABEL_PROFILE: "1x1",
                            c.LABEL_ORIGIN: "0-0", c.LABEL_DIMS: "1-1"}}}]}})
    conn.request("POST", "/v2/projects/proj-1/locations/us-central2-b/queuedResources"
                 "?queuedResourceId=nos-raw-1", body=body,
                 headers={"Content-Type": "application/json"})
    resp = json.loads(conn.getresponse().read())
    conn.close()
    assert resp["name"].startswith("projects/proj-1/locations/us-central2-b/operations/op-")
    assert resp["done"] is True and "error" not in resp


def _lifecycle(p, client):
    h = client.create_slice(p.P("2x2"), (0, 0), (2, 2))
    assert h.profile == p.P("2x2") and h.origin == (0, 0) and not h.in_use
    h2 = client.create_slice(p.P("1x2"), (2, 0), (1, 2))
    assert {s.slice_id for s in client.list_slices()} == {h.slice_id, h2.slice_id}
    client.set_slice_in_use(h.slice_id, True)
    assert [s.in_use for s in client.list_slices() if s.slice_id == h.slice_id] == [True]
    with pytest.raises(p.interface.TpuLibError):
        client.delete_slice(h.slice_id)
    assert client.delete_all_except([]) == [h2.slice_id]
    client.set_slice_in_use(h.slice_id, False)
    client.delete_slice(h.slice_id)
    assert client.list_slices() == []
    assert client.health() is None


def test_lifecycle_over_http(p, server):
    _lifecycle(p, make_cloud(p, server))


def test_in_use_lives_on_the_node_not_the_spec(p, server):
    client = make_cloud(p, server)
    h = client.create_slice(p.P("2x2"), (0, 0), (2, 2))
    client.set_slice_in_use(h.slice_id, True)
    qr = client._get_qr(h.slice_id)
    assert qr["tpu"]["nodeSpec"][0]["node"]["labels"][p.cloud.LABEL_IN_USE] == "false"
    assert client.list_slices()[0].in_use is True
    fresh = make_cloud(p, server)
    assert fresh.delete_all_except([]) == []
    assert len(fresh.list_slices()) == 1


def test_plain_rate_limit_is_not_quota_exhaustion(p):
    c = p.cloud
    raw = json.dumps({"error": {"code": 429, "message": "rate limited",
                                "status": "RESOURCE_EXHAUSTED"}}).encode()
    err = c.CloudTpuClient._to_error(429, raw)
    assert isinstance(err, c.CloudApiError)
    assert not isinstance(err, c.QuotaExhaustedError)


def test_quota_exhaustion_is_async_and_typed(p, server):
    server.quota_chips = 4
    client = make_cloud(p, server)
    client.create_slice(p.P("2x2"), (0, 0), (2, 2))
    with pytest.raises(p.cloud.QuotaExhaustedError):
        client.create_slice(p.P("2x2"), (2, 2), (2, 2))
    assert len(server.qrs) == 1
    assert len(client.list_slices()) == 1


def test_slow_provisioning_polls_to_active(p, server):
    server.provision_delay_s = 0.15
    h = make_cloud(p, server).create_slice(p.P("1x1"), (0, 0), (1, 1))
    assert h.profile == p.P("1x1")
    gets = [r for r in server.requests if r["method"] == "GET" and r["path"].endswith(h.slice_id)]
    assert len(gets) >= 2


def test_provisioning_timeout_is_typed_and_cleans_up(p, server):
    server.provision_delay_s = 60.0
    client = make_cloud(p, server, provision_timeout_s=0.1)
    with pytest.raises(p.cloud.ProvisioningTimeout):
        client.create_slice(p.P("1x1"), (0, 0), (1, 1))
    assert client.list_slices() == []


def test_transient_500_and_429_are_retried(p, server):
    client = make_cloud(p, server)
    server.fail_next_requests = 2
    h = client.create_slice(p.P("1x1"), (1, 1), (1, 1))
    server.ratelimit_next = 2
    assert [s.slice_id for s in client.list_slices()] == [h.slice_id]


def test_retries_exhausted_raises(p, server):
    client = make_cloud(p, server, max_retries=1)
    server.fail_next_requests = 10
    with pytest.raises(p.cloud.TpuLibError):
        client.list_slices()
    server.fail_next_requests = 0
    assert client.health() is None


def test_partial_failure_async_create_error(p, server):
    server.fail_next_creates_async = 1
    client = make_cloud(p, server)
    with pytest.raises(p.cloud.ProvisioningError):
        client.create_slice(p.P("2x2"), (0, 0), (2, 2))
    assert client.list_slices() == []


def test_health_reports_unreachable(p, server):
    client = make_cloud(p, server, max_retries=0)
    server.stop()
    reason = client.health()
    assert reason is not None and "unhealthy" in reason


def test_auth_header_sent(p, server):
    server.require_auth = True
    assert make_cloud(p, server).create_slice(p.P("1x1"), (0, 0), (1, 1)).slice_id
    unauth = p.cloud.CloudTpuClient(p.T("v5e", "4x4"), project="proj-1", zone="us-central2-b",
                                    base_url=server.base_url, token_provider=lambda: None,
                                    max_retries=0)
    with pytest.raises(p.cloud.CloudApiError) as exc_info:
        unauth.list_slices()
    assert exc_info.value.code == 401


# -- test_local_tpulib.py -----------------------------------------------------
class StubDevice:
    platform = "tpu"

    def __init__(self, kind, coords):
        self.device_kind = kind
        self.coords = coords


def stub_devices(p, monkeypatch, devices):
    monkeypatch.setattr(p.local, "_local_tpu_devices", lambda: list(devices))


def real_device(p):
    """A device the probe can run on here: JAX's first CPU device for the
    reference, a stub record over the CPU for the port."""
    if p.pkg == "nos_tpu":
        return jax.devices()[0]
    d = StubDevice("TPU v5 lite", (0, 0, 0))
    d.id = 0
    d.torch_device = torch.device("cpu")
    return d


def patch_transfer(p, monkeypatch, fn):
    """Route the probe's first step (JAX's `device_put`, the port's
    `torch.ones` on the device) through `fn(real, *args, **kw)`."""
    if p.pkg == "nos_tpu":
        real = jax.device_put
        monkeypatch.setattr(jax, "device_put", lambda *a, **kw: fn(real, *a, **kw))
    else:
        real = torch.ones
        monkeypatch.setattr(torch, "ones", lambda *a, **kw: fn(real, *a, **kw))


def test_generation_mapping_longest_prefix_wins(p):
    g = p.local.generation_for_device_kind
    assert g("TPU v5 lite") == "v5e"
    assert g("TPU v5e") == "v5e"
    assert g("TPU v5p") == "v5p"
    assert g("TPU v5") == "v5p"
    assert g("TPU v4") == "v4"
    assert g("TPU v6 lite") == "v6e"
    assert g("TPU v2") is None
    assert g("H100") is None


def test_discover_2d_mesh_from_coords(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", [x, y, 0])
                                  for x in range(2) for y in range(4)])
    assert p.local.discover_local_topology() == p.T("v5e", "2x4")


def test_discover_3d_mesh_for_cuboid_generations(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v4", [x, y, z])
                                  for x in range(2) for y in range(2) for z in range(2)])
    assert p.local.discover_local_topology() == p.T("v4", "2x2x2")


def test_discover_single_chip_is_1x1(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", [0, 0, 0])])
    assert p.local.discover_local_topology() == p.T("v5e", "1x1")


def test_discover_rejects_mixed_kinds(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v4", [0, 0, 0]),
                                  StubDevice("TPU v5 lite", [1, 0, 0])])
    with pytest.raises(p.tpulib.TpuLibError, match="mixed device kinds"):
        p.local.discover_local_topology()


def test_discover_rejects_unknown_kind(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v2", [0, 0, 0])])
    with pytest.raises(p.tpulib.TpuLibError, match="unknown TPU device kind"):
        p.local.discover_local_topology()


def test_discover_requires_coords(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", None)])
    with pytest.raises(p.tpulib.TpuLibError, match="no chip coordinates"):
        p.local.discover_local_topology()


def test_discover_malformed_coords_raise_the_typed_error(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v4", [0, 0])])
    with pytest.raises(p.tpulib.TpuLibError, match="shorter than the v4 mesh rank"):
        p.local.discover_local_topology()
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", ["x", "y", 0])])
    with pytest.raises(p.tpulib.TpuLibError, match="malformed chip coordinates"):
        p.local.discover_local_topology()


def test_no_tpu_devices_raises_and_visibility_is_false(p):
    """The reference's enumeration is JAX's CPU backend here; the port's is
    the CUDA runtime (no device here, an H100 on the card: neither is a
    TPU)."""
    if p.pkg == "nos_tpu" and jax.default_backend() == "tpu":
        pytest.skip("needs the chip-less CPU backend")
    with pytest.raises(p.tpulib.TpuLibError, match="no local TPU devices"):
        p.local._local_tpu_devices()
    assert p.local.local_chips_visible() is False


def test_discover_rejects_holey_enumeration(p, monkeypatch):
    devices = [StubDevice("TPU v5 lite", [x, y, 0]) for x in range(2) for y in range(2)]
    del devices[1]
    stub_devices(p, monkeypatch, devices)
    with pytest.raises(p.tpulib.TpuLibError, match="incomplete chip enumeration"):
        p.local.discover_local_topology()


def test_verify_topology_agreement_and_mismatch(p):
    v = p.local.verify_topology
    assert v(p.T("v5e", "2x2"), p.T("v5e", "2x2")) is None
    msg = v(p.T("v5e", "2x2"), p.T("v5e", "4x4"))
    assert "device runtime reports v5e-2x2" in msg
    assert "labels declare v5e-4x4" in msg


def test_verify_topology_transposed_enumeration_corroborates(p):
    v = p.local.verify_topology
    assert v(p.T("v5e", "4x2"), p.T("v5e", "2x4")) is None
    assert v(p.T("v5e", "4x2"), p.T("v5e", "2x8")) is not None
    assert v(p.T("v5e", "2x2"), p.T("v6e", "2x2")) is not None


def test_client_adopts_label_orientation_for_transposed_mesh(p, monkeypatch):
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", [x, y, 0])
                                  for x in range(4) for y in range(2)])
    expected = p.T("v5e", "2x4")
    client = p.local.LocalChipClient(expected=expected)
    assert client.topology_mismatch is None
    assert client.get_topology() == expected
    profile = expected.allowed_profiles[0]
    client.create_slice(profile, (0, 3), (1, 1))
    with pytest.raises(p.tpulib.TpuLibError, match="out of mesh bounds"):
        client.create_slice(profile, (3, 0), (1, 1))


def make_local(p, monkeypatch, shape="2x2", expected=None):
    dims = [int(x) for x in shape.split("x")]
    stub_devices(p, monkeypatch, [StubDevice("TPU v5 lite", [x, y, 0])
                                  for x in range(dims[0]) for y in range(dims[1])])
    return p.local.LocalChipClient(expected=expected)


def test_client_slice_lifecycle_on_discovered_topology(p, monkeypatch):
    client = make_local(p, monkeypatch, "2x2")
    profile = client.get_topology().allowed_profiles[0]
    handle = client.create_slice(profile, (0, 0), (1, 1))
    assert [s.slice_id for s in client.list_slices()] == [handle.slice_id]
    with pytest.raises(p.tpulib.TpuLibError, match="out of mesh bounds"):
        client.create_slice(profile, (3, 3), (1, 1))
    client.delete_slice(handle.slice_id)
    assert client.list_slices() == []


def test_client_topology_mismatch_is_surfaced_not_fatal(p, monkeypatch):
    client = make_local(p, monkeypatch, "2x2", expected=p.T("v5e", "8x8"))
    assert client.topology_mismatch is not None
    assert "8x8" in client.topology_mismatch
    assert client.get_topology() == p.T("v5e", "2x2")


def test_health_probe_success_and_failure_paths(p, monkeypatch):
    client = make_local(p, monkeypatch, "1x1")
    client._devices = [real_device(p)]
    assert client.health() is None

    class BrokenDevice:
        platform = "tpu"
        device_kind = "TPU v5 lite"
        coords = (0, 0, 0)

    client._devices = [BrokenDevice()]
    reason = client.health()
    assert reason is not None and reason.startswith("chip (0, 0, 0):")


def test_health_probe_watchdog_catches_hangs(p, monkeypatch):
    client = make_local(p, monkeypatch, "1x1")
    client._devices = [real_device(p)]
    client.probe_timeout_s = 0.2

    def wedged(real, *a, **kw):
        time.sleep(10.0)
        return real(*a, **kw)

    patch_transfer(p, monkeypatch, wedged)
    reason = client.health()
    assert reason is not None and "timed out" in reason
    before = threading.active_count()
    for _ in range(5):
        again = client.health()
        assert again is not None and "timed out" in again
    assert threading.active_count() == before


def test_device_stats_skips_wedged_chips_and_survives_hangs(p, monkeypatch):
    calls = []

    class HangingDevice(StubDevice):
        def memory_stats(self):
            calls.append("hang")
            time.sleep(10.0)
            return {}

    stub_devices(p, monkeypatch, [HangingDevice("TPU v5 lite", [0, 0, 0])])
    client = p.local.LocalChipClient()
    client.probe_timeout_s = 0.2
    stats = client.device_stats()
    assert len(stats) == 1 and "hbm_bytes_in_use" not in stats[0]
    assert client._wedged
    stats = client.device_stats()
    assert calls == ["hang"]
    assert len(stats) == 1


def test_erroring_probe_is_retried_not_condemned(p, monkeypatch):
    client = make_local(p, monkeypatch, "1x1")
    flaky = {"fail": True}

    def flaky_transfer(real, *a, **kw):
        if flaky["fail"]:
            raise RuntimeError("RPC timed out mid-transfer")
        return real(*a, **kw)

    patch_transfer(p, monkeypatch, flaky_transfer)
    client._devices = [real_device(p)]
    reason = client.health()
    assert reason is not None and "RPC timed out" in reason
    assert not client._wedged
    flaky["fail"] = False
    assert client.health() is None


def on_tpu(p):
    """The reference's real-TPU gate (`jax.default_backend() == "tpu"`);
    the port's is `local_chips_visible()`, False on a GPU host."""
    if p.pkg == "nos_tpu":
        return jax.default_backend() == "tpu"
    return p.local.local_chips_visible()


def test_real_chip_discovery_and_health(p):
    if not on_tpu(p):
        pytest.skip("real-TPU gate; the CPU and a GPU use stubs")
    topo = p.local.discover_local_topology()
    assert topo.generation in ("v4", "v5e", "v5p", "v6e")
    assert p.local.LocalChipClient().health() is None


def test_real_chip_device_stats_shape(p):
    if not on_tpu(p):
        pytest.skip("real-TPU gate; the CPU and a GPU use stubs")
    client = p.local.LocalChipClient()
    stats = client.device_stats()
    assert len(stats) == client.get_topology().chips
    for entry in stats:
        assert entry["device_kind"]
        assert isinstance(entry["coords"], tuple)


def test_real_chip_slice_lifecycle(p):
    if not on_tpu(p):
        pytest.skip("real-TPU gate; the CPU and a GPU use stubs")
    client = p.local.LocalChipClient()
    topo = client.get_topology()
    profile = topo.allowed_profiles[0]
    handle = client.create_slice(profile, (0,) * topo.shape.rank, profile.shape.dims)
    client.set_slice_in_use(handle.slice_id, True)
    with pytest.raises(p.tpulib.TpuLibError, match="in use"):
        client.delete_slice(handle.slice_id)
    client.set_slice_in_use(handle.slice_id, False)
    client.delete_slice(handle.slice_id)
    assert client.list_slices() == []


# -- the agent cases (controllers/tpu_agent.py) -------------------------------
def agent_cluster(p):
    """A cluster holding test_e2e_partitioning.py's `make_tpu_node()`, in
    package `p`."""
    o, c = p.objects, p.constants
    resources = {"cpu": 64, "memory": "128Gi", "google.com/tpu": 16}
    cluster = p.Cluster()
    cluster.create(o.Node(
        metadata=o.ObjectMeta(name="tpu-node-0", labels={
            c.LABEL_PARTITIONING: c.KIND_TPU,
            c.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            c.LABEL_TPU_TOPOLOGY: "4x4"}),
        status=o.NodeStatus(allocatable=p.ResourceList.of(resources),
                            capacity=p.ResourceList.of(resources))))
    return cluster


def drive_agent_with_spec(p, client, plan_id):
    """The spec-plan scenario the fake, native, provisioning and local
    clients are all held to: 2 x 2x2 and 1 x 1x2 on a 4x4 node."""
    constants = p.constants
    cluster = agent_cluster(p)
    agent = p.tpu_agent.TpuAgent(cluster, "tpu-node-0", client)
    agent.startup()
    cluster.patch(
        "Node",
        "",
        "tpu-node-0",
        lambda n: n.metadata.annotations.update(
            {
                "tpu.nos/spec-dev-0-2x2": "2",
                "tpu.nos/spec-dev-0-1x2": "1",
                constants.ANNOTATION_SPEC_PLAN: plan_id,
            }
        ),
    )
    agent.reconcile()
    node = cluster.get("Node", "", "tpu-node-0")
    assert node.metadata.annotations[constants.ANNOTATION_STATUS_PLAN] == plan_id
    assert node.metadata.annotations["tpu.nos/status-dev-0-2x2-free"] == "2"
    assert node.status.allocatable["google.com/tpu-2x2"] == 2
    assert node.status.allocatable["google.com/tpu-1x2"] == 1
    assert node.status.allocatable[constants.RESOURCE_TPU] == 16 - 8 - 2
    return cluster, agent


def test_native_client_drives_tpu_agent_e2e(native):
    """The node agent runs unchanged over the native client (same interface
    seam as the fake) — the cgo-vs-mock parity of the reference."""
    p = native
    drive_agent_with_spec(p, p.native.NativeTpuClient(p.T("v5e", "4x4")), "plan-native-1")


def test_cloud_client_drives_tpu_agent_e2e(p, server):
    """Identical scenario to test_native_client_drives_tpu_agent_e2e: the
    node agent's actuate/report loop over the provisioning surface, no agent
    changes — the TpuClient seam holds for real infrastructure."""
    constants = p.constants
    client = make_cloud(p, server)
    cluster, agent = drive_agent_with_spec(p, client, "plan-cloud-1")
    # The carves exist on the provisioning surface, geometry intact.
    by_profile = {}
    for s in client.list_slices():
        by_profile[s.profile.name] = by_profile.get(s.profile.name, 0) + 1
    assert by_profile == {"2x2": 2, "1x2": 1}

    # Shrink the spec: the agent deletes the surplus free slice via the API.
    cluster.patch(
        "Node", "", "tpu-node-0",
        lambda n: (
            n.metadata.annotations.pop("tpu.nos/spec-dev-0-1x2"),
            n.metadata.annotations.update(
                {constants.ANNOTATION_SPEC_PLAN: "plan-cloud-2"}
            ),
        ),
    )
    agent.reconcile()
    assert {s.profile.name for s in client.list_slices()} == {"2x2"}
    node = cluster.get("Node", "", "tpu-node-0")
    assert node.metadata.annotations[constants.ANNOTATION_STATUS_PLAN] == "plan-cloud-2"


def test_agent_startup_cleanup_over_cloud(p, server):
    """Crash recovery: slices left by a dead agent are deleted through the
    provisioning API on startup (cmd/migagent/migagent.go:190-199 analog)."""
    client = make_cloud(p, server)
    client.create_slice(p.P("2x2"), (0, 0), (2, 2))  # orphan from a "crash"
    cluster = agent_cluster(p)
    agent = p.tpu_agent.TpuAgent(cluster, "tpu-node-0", make_cloud(p, server))
    agent.startup()
    assert client.list_slices() == []


def test_local_client_drives_tpu_agent_e2e(p, monkeypatch):
    """The node agent runs unchanged over the real-silicon client — the
    same spec-plan scenario the fake and native backends are held to.
    Enumeration is stubbed at 4x4."""
    drive_agent_with_spec(p, make_local(p, monkeypatch, "4x4"), "plan-local-1")


def test_device_stats_exports_hbm_gauges_through_agent(p, monkeypatch):
    """Per-chip runtime stats flow into the metrics surface: a backend
    exposing memory_stats yields nos_tpu_chip_hbm_* gauges labeled by
    chip; entries without stats (tunnel-attached runtimes) export
    nothing rather than zeros."""
    metrics = p.metrics
    metrics.__init__()

    class StatsDevice(StubDevice):
        def __init__(self, kind, coords, stats):
            super().__init__(kind, coords)
            self._stats = stats

        def memory_stats(self):
            return self._stats

    stub_devices(
        p,
        monkeypatch,
        [
            StatsDevice(
                "TPU v5 lite", [0, 0, 0],
                {"bytes_in_use": 1 << 30, "bytes_limit": 16 << 30},
            ),
            StatsDevice("TPU v5 lite", [1, 0, 0], None),  # tunnel: no stats
            StatsDevice("TPU v5 lite", [2, 0, 0], None),
            StatsDevice("TPU v5 lite", [3, 0, 0], None),
        ],
    )
    client = p.local.LocalChipClient(expected=p.T("v5e", "4x1"))
    assert client.topology_mismatch is None

    stats = client.device_stats()
    assert stats[0]["hbm_bytes_in_use"] == 1 << 30
    assert stats[0]["hbm_bytes_limit"] == 16 << 30
    assert "hbm_bytes_in_use" not in stats[1]

    cluster = agent_cluster(p)
    agent = p.tpu_agent.TpuAgent(cluster, "tpu-node-0", client)
    agent.startup()
    agent.report()
    rendered = metrics.render()
    assert 'nos_tpu_chip_hbm_bytes_in_use{chip="0x0x0",node="tpu-node-0"}' in rendered
    assert 'nos_tpu_chip_hbm_bytes_limit{chip="0x0x0",node="tpu-node-0"}' in rendered
    assert 'chip="1x0x0"' not in rendered  # no stats -> no gauge

    # A chip that STOPS reporting must drop its series, not freeze: a
    # stale last value on /metrics reads as a live measurement.
    client._devices[0]._stats = None
    agent.report()
    rendered = metrics.render()
    assert "nos_tpu_chip_hbm_bytes_in_use" not in rendered


# -- the port's own seams -----------------------------------------------------
def test_port_enumerates_cuda_devices_and_names_their_kind(monkeypatch):
    """With the CUDA runtime reporting one H100 (stubbed here), the port
    lists it under its runtime name, keeps it out of the TPU filter, and
    discovery raises the typed error naming the kind."""
    local = PORT.local
    monkeypatch.setattr(local.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(local.torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    (rec,) = local._local_devices()
    assert (rec.platform, rec.device_kind, rec.id, rec.coords) == (
        "gpu", "NVIDIA H100 80GB HBM3", 0, None)
    assert rec.torch_device == torch.device("cuda", 0)
    with pytest.raises(PORT.tpulib.TpuLibError, match="NVIDIA H100 80GB HBM3"):
        local.discover_local_topology()
    assert local.local_chips_visible() is False


def test_port_memory_stats_keys_from_the_allocator(monkeypatch):
    """`CudaDevice.memory_stats()` gives the reference's keys from torch's
    allocator (stubbed here), and `device_stats()` of a client over the
    record relabelled as a TPU chip exports them under the reference's
    names."""
    local = PORT.local
    cuda = local.torch.cuda
    monkeypatch.setattr(cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(cuda, "memory_allocated", lambda d: 5 << 20)
    monkeypatch.setattr(cuda, "max_memory_allocated", lambda d: 7 << 20)
    monkeypatch.setattr(cuda, "mem_get_info", lambda d: (1 << 30, 80 << 30))
    rec = local.CudaDevice(0)
    assert rec.memory_stats() == {"bytes_in_use": 5 << 20, "bytes_limit": 80 << 30,
                                  "peak_bytes_in_use": 7 << 20}
    rec.platform, rec.device_kind, rec.coords = "tpu", "TPU v5 lite", (0, 0, 0)
    monkeypatch.setattr(local, "_local_tpu_devices", lambda: [rec])
    client = local.LocalChipClient()
    assert client.get_topology() == PORT.T("v5e", "1x1")
    assert client.device_stats() == [{
        "coords": (0, 0, 0), "device_kind": "TPU v5 lite", "hbm_bytes_in_use": 5 << 20,
        "hbm_bytes_limit": 80 << 30, "hbm_peak_bytes_in_use": 7 << 20}]


def test_port_probe_on_stub_records():
    """`_probe_chip` adds on the record's torch device: (None, False) on
    the CPU; a device the runtime refuses is a completed probe with its
    error, not a timeout; a record without a device too."""
    local = PORT.local
    good = types.SimpleNamespace(torch_device=torch.device("cpu"))
    assert local._probe_chip(good, 30.0) == (None, False)
    reason, timed_out = local._probe_chip(types.SimpleNamespace(torch_device="no-such-device"), 30.0)
    assert reason.startswith("RuntimeError") and "no-such-device" in reason and not timed_out
    reason, timed_out = local._probe_chip(types.SimpleNamespace(), 30.0)
    assert reason.startswith("AttributeError") and not timed_out


@pytest.mark.parametrize("n", [1, 4, 8])
def test_discovery_equal_across_packages_on_stub_enumerations(monkeypatch, n):
    """Seeded stub enumerations (shuffled, transposed, holey, mixed) give
    the same topology or the same error text in both packages."""
    rng = random.Random(n)
    for _ in range(20):
        kind = rng.choice(["TPU v5 lite", "TPU v4", "TPU v6e", "TPU v5p", "TPU v3"])
        rank = 3 if kind in ("TPU v4", "TPU v5p") else 2
        dims = [rng.choice([d for d in (1, 2, 4, 8) if d <= n]) for _ in range(rank)]
        coords = [list(c) + [0] * (3 - rank) for c in itertools.product(*[range(d) for d in dims])]
        rng.shuffle(coords)
        if rng.random() < 0.2 and len(coords) > 1:
            coords.pop()
        devs = [StubDevice(kind, c) for c in coords]
        out = []
        for m in (REF, PORT):
            monkeypatch.setattr(m.local, "_local_tpu_devices", lambda devs=devs: list(devs))
            try:
                out.append(str(m.local.discover_local_topology()))
            except m.tpulib.TpuLibError as e:
                out.append(f"error: {e}")
        assert out[0] == out[1], (kind, dims)


def test_native_pack_equal_across_packages():
    """Both shims on the same inputs (meshes of every generation up to 512
    chips, seeded geometries, occupied blocks), and the port's shim equal
    to the port's Python packer."""
    assert REF.native.ensure_built() and PORT.native.ensure_built()
    rng = random.Random(3)
    cases = 0
    for gen, mesh in [("v5e", "4x4"), ("v5e", "16x16"), ("v6e", "8x16"), ("v4", "4x4x8"),
                      ("v5p", "8x8x8")]:
        menu = [q.name for q in REF.T(gen, mesh).allowed_profiles]
        for _ in range(40):
            named = {}
            for _ in range(rng.randint(1, 5)):
                q = rng.choice(menu)
                named[q] = named.get(q, 0) + rng.randint(1, 4)
            first = REF.tpu.pack(REF.tpu.Shape.parse(mesh), {REF.P(menu[0]): 1})
            occupied = [(pl.origin, pl.dims) for pl in first][: rng.randint(0, 1)]
            got = []
            for m in (REF, PORT):
                geo = {m.P(q): c for q, c in named.items()}
                got.append(m.native.native_pack(m.tpu.Shape.parse(mesh).dims, occupied, geo))
            py = PORT.packing.pack_into(PORT.tpu.Shape.parse(mesh), occupied,
                                        {PORT.P(q): c for q, c in named.items()})
            assert got[0] == got[1], (mesh, named)
            assert got[1] == (None if py is None else [(pl.origin, pl.dims) for pl in py])
            cases += got[1] is not None
    assert cases > 20


def test_both_shims_load_from_their_own_files():
    """One process holds both libraries: each package's from its own
    directory, under its own name, and the port's from nothing under
    nos_tpu/."""
    ref_lib, port_lib = REF.native.load_library(), PORT.native.load_library()
    assert ref_lib is not None and port_lib is not None
    ref_path, port_path = Path(ref_lib._name).resolve(), Path(port_lib._name).resolve()
    assert ref_path != port_path and ref_path.name != port_path.name
    assert port_path.parent == (REPO / "nos_tpu_torch" / "tpulib" / "native" / "_build")
    assert port_path.name.startswith("libtpuslice_torch-")
    assert (REPO / "nos_tpu") not in port_path.parents


def test_importing_the_port_tpulib_builds_nothing():
    """Every module of nos_tpu_torch.tpulib imports in a fresh process
    (torch already loaded) where running a compiler or loading a library
    raises: nothing is built or loaded until first use."""
    code = (
        "import subprocess, ctypes, numpy, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a build or a load at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import pkgutil, importlib, sys, nos_tpu_torch.tpulib as t\n"
        "for m in pkgutil.walk_packages(t.__path__, 'nos_tpu_torch.tpulib.'):\n"
        "    importlib.import_module(m.name)\n"
        "nc = sys.modules['nos_tpu_torch.tpulib.native_client']\n"
        "assert nc._lib is None\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'nos_tpu.')) for m in sys.modules)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr


def test_load_library_is_none_when_the_build_fails(monkeypatch, tmp_path):
    """The reference's contract: no compiler, no library, None (the caller
    then uses FakeTpuClient); `NativeTpuClient` and `native_pack` raise
    the typed error."""
    nc = PORT.native
    monkeypatch.setattr(nc, "_lib", None)
    monkeypatch.setattr(nc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert nc.ensure_built() is False
    assert nc.load_library() is None
    assert list((tmp_path / "_build").iterdir()) == []
    with pytest.raises(PORT.tpulib.TpuLibError, match="unavailable"):
        nc.NativeTpuClient(PORT.T("v5e", "2x2"))
    with pytest.raises(PORT.tpulib.TpuLibError, match="unavailable"):
        nc.native_pack((2, 2), [], {PORT.P("1x1"): 1})


@pytest.mark.parametrize("client_pkg,server_pkg", [("nos_tpu", "nos_tpu_torch"),
                                                   ("nos_tpu_torch", "nos_tpu")])
def test_cloud_client_against_the_other_packages_server(client_pkg, server_pkg):
    """The wire protocol holds across packages: one package's client drives
    the other's fake provisioning surface through the whole lifecycle,
    with equal recorded requests."""
    cm, sm = load(client_pkg), load(server_pkg)
    srv = sm.cloud_server.FakeCloudTpuServer()
    srv.base_url = srv.start()
    try:
        srv.provision_delay_s = 0.05
        _lifecycle(cm, make_cloud(cm, srv))
        methods = [r["method"] for r in srv.requests]
        assert methods.count("POST") == 2 and methods.count("DELETE") == 2
    finally:
        srv.stop()
