"""Port of `nos_tpu/cluster/pod_resources_grpc.py` (:1-367): `encode_varint`
(:42), `encode_field` (:74), `encode_str` (:81), `encode_msg` (:85),
`encode_int` (:89), `decode_fields` (:93), `ContainerDevices` (:136),
`ContainerResources` (:160), .... Copied verbatim; only the imports point at
the port, which imports nothing of the JAX package.

kubelet pod-resources gRPC client (the real socket).

The reference talks to the kubelet's pod-resources API over
``unix:///var/lib/kubelet/pod-resources/kubelet.sock``
(pkg/resource/client.go:26-87, lister.go:14-24) to learn which accelerator
devices exist and which are allocated to pods. This module is that client:
real gRPC over the unix socket, speaking the ``v1.PodResourcesLister``
service (k8s.io/kubelet/pkg/apis/podresources/v1/api.proto).

No generated stubs: the image has grpc but no grpc_tools, so the protobuf
messages are (de)serialized by a small hand-rolled wire codec below —
the two requests are empty messages (zero bytes on the wire) and the
responses use only varint + length-delimited fields. The codec is symmetric
(encode + decode) so tests can run a fake kubelet server with the same
module (the reference mocks pdrv1.PodResourcesListerClient; we go one layer
lower and fake the socket itself).

Gating: construct ``KubeletPodResourcesClient`` only on a real node (the
reference gates with the ``nvml`` build tag; here nothing imports grpc until
the client is built). It satisfies the ``PodResourcesLister`` protocol from
cluster/pod_resources.py, so agents accept it wherever the in-process seam
is used.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

from nos_tpu_torch.cluster.pod_resources import STATUS_FREE, STATUS_USED, DeviceEntry

DEFAULT_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
SERVICE = "v1.PodResourcesLister"

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


# -- protobuf wire codec -----------------------------------------------------
def encode_varint(value: int) -> bytes:
    if value < 0:
        # proto3 would two's-complement this into 10 bytes; nothing in the
        # pod-resources API carries negatives, so refuse rather than loop.
        raise ValueError("negative varints are not supported")
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def encode_field(number: int, wire_type: int, payload: bytes) -> bytes:
    key = encode_varint((number << 3) | wire_type)
    if wire_type == _WIRE_LEN:
        return key + encode_varint(len(payload)) + payload
    return key + payload


def encode_str(number: int, value: str) -> bytes:
    return encode_field(number, _WIRE_LEN, value.encode())


def encode_msg(number: int, payload: bytes) -> bytes:
    return encode_field(number, _WIRE_LEN, payload)


def encode_int(number: int, value: int) -> bytes:
    return encode_field(number, _WIRE_VARINT, encode_varint(value))


def decode_fields(buf: bytes) -> Dict[int, List[bytes]]:
    """Parse a message into {field_number: [raw payloads]} — varints are
    re-encoded as their integer value bytes via int fields below."""
    out: Dict[int, List[bytes]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        number, wire_type = key >> 3, key & 0x7
        if wire_type == _WIRE_VARINT:
            value, pos = _decode_varint(buf, pos)
            out.setdefault(number, []).append(encode_varint(value))
        elif wire_type == _WIRE_LEN:
            length, pos = _decode_varint(buf, pos)
            if pos + length > len(buf):
                raise ValueError("truncated length-delimited field")
            out.setdefault(number, []).append(buf[pos : pos + length])
            pos += length
        elif wire_type == _WIRE_I64:
            out.setdefault(number, []).append(buf[pos : pos + 8])
            pos += 8
        elif wire_type == _WIRE_I32:
            out.setdefault(number, []).append(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
    return out


def _one_int(fields: Dict[int, List[bytes]], number: int, default: int = 0) -> int:
    if number not in fields:
        return default
    value, _ = _decode_varint(fields[number][-1], 0)
    return value


def _one_str(fields: Dict[int, List[bytes]], number: int) -> str:
    if number not in fields:
        return ""
    return fields[number][-1].decode()


# -- v1.PodResourcesLister messages ------------------------------------------
@dataclass
class ContainerDevices:
    """api.proto ContainerDevices: resource_name=1, device_ids=2."""

    resource_name: str = ""
    device_ids: List[str] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.resource_name:
            out += encode_str(1, self.resource_name)
        for d in self.device_ids:
            out += encode_str(2, d)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ContainerDevices":
        f = decode_fields(buf)
        return cls(
            resource_name=_one_str(f, 1),
            device_ids=[b.decode() for b in f.get(2, [])],
        )


@dataclass
class ContainerResources:
    """api.proto ContainerResources: name=1, devices=2."""

    name: str = ""
    devices: List[ContainerDevices] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.name:
            out += encode_str(1, self.name)
        for d in self.devices:
            out += encode_msg(2, d.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ContainerResources":
        f = decode_fields(buf)
        return cls(
            name=_one_str(f, 1),
            devices=[ContainerDevices.decode(b) for b in f.get(2, [])],
        )


@dataclass
class PodResources:
    """api.proto PodResources: name=1, namespace=2, containers=3."""

    name: str = ""
    namespace: str = ""
    containers: List[ContainerResources] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.name:
            out += encode_str(1, self.name)
        if self.namespace:
            out += encode_str(2, self.namespace)
        for c in self.containers:
            out += encode_msg(3, c.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "PodResources":
        f = decode_fields(buf)
        return cls(
            name=_one_str(f, 1),
            namespace=_one_str(f, 2),
            containers=[ContainerResources.decode(b) for b in f.get(3, [])],
        )


@dataclass
class ListPodResourcesResponse:
    """api.proto ListPodResourcesResponse: pod_resources=1."""

    pod_resources: List[PodResources] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(encode_msg(1, p.encode()) for p in self.pod_resources)

    @classmethod
    def decode(cls, buf: bytes) -> "ListPodResourcesResponse":
        f = decode_fields(buf)
        return cls(pod_resources=[PodResources.decode(b) for b in f.get(1, [])])


@dataclass
class AllocatableResourcesResponse:
    """api.proto AllocatableResourcesResponse: devices=1 (cpu_ids/memory
    ignored — the reference reads only devices, client.go:43-56)."""

    devices: List[ContainerDevices] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(encode_msg(1, d.encode()) for d in self.devices)

    @classmethod
    def decode(cls, buf: bytes) -> "AllocatableResourcesResponse":
        f = decode_fields(buf)
        return cls(devices=[ContainerDevices.decode(b) for b in f.get(1, [])])


def _encode_empty(_request) -> bytes:
    return b""


# -- the client --------------------------------------------------------------
class KubeletPodResourcesClient:
    """PodResourcesLister over the kubelet gRPC socket.

    ``get_allocatable_devices`` = GetAllocatableResources flattened to one
    entry per device id, with status joined against List (the reference
    returns StatusUnknown there and joins later; callers of this seam expect
    used/free, so the join happens here). ``get_used_devices`` = List
    flattened (client.go:62-87).
    """

    def __init__(self, socket_path: str = DEFAULT_SOCKET, timeout_s: float = 10.0):
        import grpc  # deferred: only node agents construct this

        target = socket_path if "://" in socket_path else f"unix://{socket_path}"
        self._timeout = timeout_s
        self._channel = grpc.insecure_channel(target)
        self._list = self._channel.unary_unary(
            f"/{SERVICE}/List",
            request_serializer=_encode_empty,
            response_deserializer=ListPodResourcesResponse.decode,
        )
        self._allocatable = self._channel.unary_unary(
            f"/{SERVICE}/GetAllocatableResources",
            request_serializer=_encode_empty,
            response_deserializer=AllocatableResourcesResponse.decode,
        )

    def close(self) -> None:
        self._channel.close()

    # raw calls
    def list_pod_resources(self) -> ListPodResourcesResponse:
        return self._list(None, timeout=self._timeout)

    def get_allocatable_resources(self) -> AllocatableResourcesResponse:
        return self._allocatable(None, timeout=self._timeout)

    # PodResourcesLister protocol
    def get_used_devices(self) -> List[DeviceEntry]:
        out: List[DeviceEntry] = []
        for pod in self.list_pod_resources().pod_resources:
            for container in pod.containers:
                for dev in container.devices:
                    for device_id in dev.device_ids:
                        out.append(
                            DeviceEntry(
                                resource_name=dev.resource_name,
                                device_id=device_id,
                                status=STATUS_USED,
                            )
                        )
        return out

    def get_allocatable_devices(self) -> List[DeviceEntry]:
        used_ids = {(d.resource_name, d.device_id) for d in self.get_used_devices()}
        out: List[DeviceEntry] = []
        for dev in self.get_allocatable_resources().devices:
            for device_id in dev.device_ids:
                status = (
                    STATUS_USED
                    if (dev.resource_name, device_id) in used_ids
                    else STATUS_FREE
                )
                out.append(
                    DeviceEntry(
                        resource_name=dev.resource_name,
                        device_id=device_id,
                        status=status,
                    )
                )
        return out


# -- fake kubelet (test seam) -------------------------------------------------
class FakeKubeletServer:
    """A real gRPC server serving canned pod-resources state over a unix
    socket — the hardware-boundary mock one layer below the reference's
    (which mocks the generated client interface)."""

    def __init__(self, socket_path: str):
        import concurrent.futures

        import grpc

        self.socket_path = socket_path
        self.allocatable: List[ContainerDevices] = []
        self.pods: List[PodResources] = []

        server = self

        def list_handler(request: bytes, context) -> ListPodResourcesResponse:
            return ListPodResourcesResponse(pod_resources=list(server.pods))

        def allocatable_handler(request: bytes, context) -> AllocatableResourcesResponse:
            return AllocatableResourcesResponse(devices=list(server.allocatable))

        handlers = grpc.method_handlers_generic_handler(
            SERVICE,
            {
                "List": grpc.unary_unary_rpc_method_handler(
                    list_handler,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda m: m.encode(),
                ),
                "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
                    allocatable_handler,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda m: m.encode(),
                ),
            },
        )
        self._server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=2))
        self._server.add_generic_rpc_handlers((handlers,))
        self._server.add_insecure_port(f"unix://{socket_path}")

    def start(self) -> "FakeKubeletServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=None)
