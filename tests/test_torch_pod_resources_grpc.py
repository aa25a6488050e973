"""The port's kubelet pod-resources client
(`nos_tpu_torch/cluster/pod_resources_grpc.py`) against the JAX package's:
the cases of tests/test_pod_resources_grpc.py on both packages. The wire
codec's cases need no grpc and run everywhere; the client cases run a
fake kubelet serving the real gRPC protocol over a unix socket and skip
where `grpc` is not installed (it stays a deferred import of the module).
In place of the reference's agent case, which needs the control plane's
node agents (not ported yet), each package's client reads the other
package's fake kubelet: the two speak one protocol."""

import importlib
import types

import pytest

PACKAGES = ("nos_tpu", "nos_tpu_torch")


def load(pkg):
    return types.SimpleNamespace(
        pkg=pkg,
        pr=importlib.import_module(f"{pkg}.cluster.pod_resources"),
        g=importlib.import_module(f"{pkg}.cluster.pod_resources_grpc"))


@pytest.fixture(params=PACKAGES)
def p(request):
    return load(request.param)


# -- wire codec ---------------------------------------------------------------
def test_varint_round_trip(p):
    for v in (0, 1, 127, 128, 300, 2**21, 2**35, 2**63 - 1):
        buf = p.g.encode_varint(v)
        out, pos = p.g._decode_varint(buf, 0)
        assert out == v and pos == len(buf)


def sample_response(g):
    return g.ListPodResourcesResponse(pod_resources=[g.PodResources(
        name="trainer-0", namespace="team-a",
        containers=[g.ContainerResources(name="main", devices=[
            g.ContainerDevices("nvidia.com/mig-1g.5gb", ["MIG-uuid-1", "MIG-uuid-2"]),
            g.ContainerDevices("google.com/tpu-2x2", ["slice-0"]),
        ])])])


def test_message_round_trip(p):
    resp = sample_response(p.g)
    assert p.g.ListPodResourcesResponse.decode(resp.encode()) == resp


def test_encoding_equal_across_packages():
    """The same message encodes to the same bytes in both packages, and
    each decodes the other's."""
    ref, port = load("nos_tpu").g, load("nos_tpu_torch").g
    blob = sample_response(ref).encode()
    assert sample_response(port).encode() == blob
    assert port.ListPodResourcesResponse.decode(blob) == sample_response(port)


def test_decoder_skips_unknown_fields(p):
    # The kubelet may send fields this client does not know (cpu_ids,
    # topology): they are skipped.
    payload = (p.g.encode_str(1, "nvidia.com/gpu") + p.g.encode_str(2, "gpu-0")
               + p.g.encode_int(3, 99))
    dev = p.g.ContainerDevices.decode(payload)
    assert dev.resource_name == "nvidia.com/gpu"
    assert dev.device_ids == ["gpu-0"]


def test_codec_agrees_with_protobuf_runtime(p):
    """Encode with the canonical protobuf runtime, decode with ours, and
    vice versa."""
    descriptor_pb2 = pytest.importorskip("google.protobuf.descriptor_pb2")
    from google.protobuf import descriptor_pool, message_factory

    pool = descriptor_pool.DescriptorPool()
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "podresources_test.proto"
    fdp.package = "v1t"
    fdp.syntax = "proto3"
    msg = fdp.message_type.add()
    msg.name = "ContainerDevices"
    f1 = msg.field.add()
    f1.name, f1.number = "resource_name", 1
    f1.type = descriptor_pb2.FieldDescriptorProto.TYPE_STRING
    f1.label = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
    f2 = msg.field.add()
    f2.name, f2.number = "device_ids", 2
    f2.type = descriptor_pb2.FieldDescriptorProto.TYPE_STRING
    f2.label = descriptor_pb2.FieldDescriptorProto.LABEL_REPEATED
    pool.Add(fdp)
    cls = message_factory.GetMessageClass(pool.FindMessageTypeByName("v1t.ContainerDevices"))

    theirs = cls(resource_name="google.com/tpu-2x2", device_ids=["a", "b"])
    ours = p.g.ContainerDevices.decode(theirs.SerializeToString())
    assert ours == p.g.ContainerDevices("google.com/tpu-2x2", ["a", "b"])
    back = cls()
    back.ParseFromString(p.g.ContainerDevices("google.com/tpu-2x2", ["a", "b"]).encode())
    assert back == theirs


def test_decode_rejects_truncated(p):
    with pytest.raises(ValueError):
        p.g.decode_fields(b"\x0a\xff")  # length-delimited claiming 255 bytes


def test_encode_rejects_negative_varint(p):
    with pytest.raises(ValueError):
        p.g.encode_varint(-1)


# -- client against fake kubelet ----------------------------------------------
@pytest.fixture()
def kubelet(p, tmp_path):
    pytest.importorskip("grpc")
    socket_path = str(tmp_path / "kubelet.sock")
    server = p.g.FakeKubeletServer(socket_path).start()
    client = p.g.KubeletPodResourcesClient(socket_path, timeout_s=10.0)
    yield server, client
    client.close()
    server.stop()


def test_allocatable_joined_with_usage(p, kubelet):
    server, client = kubelet
    g = p.g
    server.allocatable = [
        g.ContainerDevices("google.com/tpu-2x2", ["slice-0", "slice-1"]),
        g.ContainerDevices("google.com/tpu-2x4", ["slice-2"]),
    ]
    server.pods = [g.PodResources(name="w0", namespace="team-a", containers=[
        g.ContainerResources("main", [g.ContainerDevices("google.com/tpu-2x2", ["slice-1"])])])]
    used = client.get_used_devices()
    assert [(d.resource_name, d.device_id, d.status) for d in used] == [
        ("google.com/tpu-2x2", "slice-1", p.pr.STATUS_USED)]
    statuses = {d.device_id: d.status for d in client.get_allocatable_devices()}
    assert statuses == {"slice-0": p.pr.STATUS_FREE, "slice-1": p.pr.STATUS_USED,
                        "slice-2": p.pr.STATUS_FREE}


def test_empty_node(p, kubelet):
    _, client = kubelet
    assert client.get_used_devices() == []
    assert client.get_allocatable_devices() == []


def test_multiple_containers_and_pods(p, kubelet):
    server, client = kubelet
    g = p.g
    server.pods = [
        g.PodResources(name=f"w{i}", namespace="ns", containers=[
            g.ContainerResources("main", [g.ContainerDevices(
                "nvidia.com/mig-1g.5gb", [f"MIG-{i}-a", f"MIG-{i}-b"])]),
            g.ContainerResources("side", [g.ContainerDevices("nvidia.com/gpu-10gb", [f"G-{i}"])]),
        ])
        for i in range(3)
    ]
    used = client.get_used_devices()
    assert len(used) == 9
    assert {d.resource_name for d in used} == {"nvidia.com/mig-1g.5gb", "nvidia.com/gpu-10gb"}


@pytest.mark.parametrize("client_pkg,server_pkg", [("nos_tpu_torch", "nos_tpu"),
                                                   ("nos_tpu", "nos_tpu_torch")])
def test_client_reads_the_other_packages_kubelet(tmp_path, client_pkg, server_pkg):
    pytest.importorskip("grpc")
    c, s = load(client_pkg), load(server_pkg)
    server = s.g.FakeKubeletServer(str(tmp_path / "kubelet.sock")).start()
    client = c.g.KubeletPodResourcesClient(str(tmp_path / "kubelet.sock"), timeout_s=10.0)
    try:
        server.allocatable = [s.g.ContainerDevices("google.com/tpu-2x2", ["slice-0", "slice-1"])]
        server.pods = [s.g.PodResources(name="w0", namespace="team-a", containers=[
            s.g.ContainerResources("main", [s.g.ContainerDevices("google.com/tpu-2x2",
                                                                 ["slice-0"])])])]
        got = [(d.resource_name, d.device_id, d.status)
               for d in client.get_allocatable_devices()]
        assert got == [("google.com/tpu-2x2", "slice-0", "used"),
                       ("google.com/tpu-2x2", "slice-1", "free")]
        assert isinstance(client.get_used_devices()[0], c.pr.DeviceEntry)
    finally:
        client.close()
        server.stop()
