"""Port of `nos_tpu/tpulib/cloud_server.py` (:1-324): `FakeCloudTpuServer`
(:48). Copied verbatim; only the imports point at the port, which imports
nothing of the JAX package.

In-process fake of the Cloud-TPU-v2-shaped provisioning surface.

The carve-path analog of ``cluster/apiserver.py``: a threaded HTTP server
speaking the documented queuedResources / operations / nodes wire shapes
(see tpulib/cloud.py's module docstring for the exact routes), with the
failure modes a real provisioning surface exhibits as injectable knobs:

  - ``quota_chips``: total chips the fake project/zone may hold; creates
    beyond it complete their operation WITH an error (RESOURCE_EXHAUSTED),
    exactly how the real surface fails on quota — async, not at POST time.
  - ``provision_delay_s``: queued resources sit in PROVISIONING until the
    delay elapses (drives the client's operation-poll and state-poll loops).
  - ``fail_next_requests``: the next N requests answer 500 (transient-fault
    retry coverage); ``ratelimit_next``: the next N answer 429 with
    Retry-After.
  - ``fail_next_creates_async``: the next N create operations complete with
    a non-quota error (partial failure: the POST succeeded, provisioning
    died later).

Tests in tests/test_cloud_tpulib.py anchor BOTH ends to golden fixtures so
this fake cannot drift from the shapes the client was written against
(the same-hand-emulator risk the kube wire fixtures closed in round 3).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

_QR_RE = re.compile(
    r"^/v2/projects/(?P<project>[^/]+)/locations/(?P<zone>[^/]+)/queuedResources"
    r"(?:/(?P<id>[^/?]+))?$"
)
_NODE_RE = re.compile(
    r"^/v2/projects/(?P<project>[^/]+)/locations/(?P<zone>[^/]+)/nodes"
    r"(?:/(?P<id>[^/?]+))?$"
)
_OP_RE = re.compile(
    r"^/v2/(?P<name>projects/[^/]+/locations/[^/]+/operations/[^/?]+)$"
)


class FakeCloudTpuServer:
    """State machine + HTTP frontend. Thread-safe; one instance per test."""

    def __init__(
        self,
        quota_chips: Optional[int] = None,
        provision_delay_s: float = 0.0,
        require_auth: bool = False,
    ):
        self.quota_chips = quota_chips
        self.provision_delay_s = provision_delay_s
        self.require_auth = require_auth
        self.fail_next_requests = 0
        self.ratelimit_next = 0
        self.fail_next_creates_async = 0
        self.lock = threading.RLock()
        self.qrs: Dict[str, dict] = {}  # id -> queued resource doc
        # id -> the provisioned Node's LIVE labels. Deliberately a separate
        # store from the qr doc: on the real surface a PATCH to /nodes/{id}
        # mutates the Node only — GET queuedResources keeps echoing the
        # creation-time nodeSpec forever. Aliasing the two (as an early
        # version of this fake did) hid a client bug that read the mutable
        # in-use mark from the immutable spec.
        self.node_labels: Dict[str, dict] = {}
        self.ops: Dict[str, dict] = {}  # full op name -> operation doc
        self.requests: List[dict] = []  # wire log for fixture assertions
        self._op_counter = 0
        self._ready_at: Dict[str, float] = {}  # qr id -> when ACTIVE
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> str:
        handler = _make_handler(self)
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        host, port = self._server.server_address
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()

    # -- helpers --------------------------------------------------------------
    def _chips_of(self, qr: dict) -> int:
        node = qr["tpu"]["nodeSpec"][0]["node"]
        accel = node.get("acceleratorType", "v5litepod-1")
        try:
            return int(accel.rsplit("-", 1)[-1])
        except ValueError:
            return 1

    def _used_chips(self) -> int:
        return sum(
            self._chips_of(qr)
            for qr in self.qrs.values()
            if qr["state"]["state"] in ("ACTIVE", "PROVISIONING", "ACCEPTED")
        )

    def _materialize_node_locked(self, qr_id: str) -> None:
        """Provisioning completed: the Node now exists, born with the
        nodeSpec's labels (the last moment spec and live labels agree)."""
        spec_labels = (
            self.qrs[qr_id]["tpu"]["nodeSpec"][0]["node"].get("labels") or {}
        )
        self.node_labels[qr_id] = dict(spec_labels)

    def _new_op(self, parent: str, done: bool = True, error: Optional[dict] = None) -> dict:
        self._op_counter += 1
        name = f"{parent}/operations/op-{self._op_counter}"
        op = {"name": name, "done": done}
        if error:
            op["error"] = error
        self.ops[name] = op
        return op

    def _settle_locked(self) -> None:
        """Advance time-driven state: PROVISIONING -> ACTIVE after the delay."""
        now = time.monotonic()
        for qr_id, at in list(self._ready_at.items()):
            if now >= at and qr_id in self.qrs:
                if self.qrs[qr_id]["state"]["state"] == "PROVISIONING":
                    self.qrs[qr_id]["state"]["state"] = "ACTIVE"
                    self._materialize_node_locked(qr_id)
                del self._ready_at[qr_id]

    # -- request handling ------------------------------------------------------
    def handle(self, method: str, path: str, query: dict, body: Optional[dict],
               headers: dict) -> tuple:
        """Returns (status, payload dict, extra headers)."""
        with self.lock:
            self.requests.append(
                {"method": method, "path": path, "query": query, "body": body}
            )
            if self.require_auth and not headers.get("Authorization", "").startswith(
                "Bearer "
            ):
                return 401, _err(401, "UNAUTHENTICATED", "missing bearer token"), {}
            if self.ratelimit_next > 0:
                self.ratelimit_next -= 1
                return (
                    429,
                    _err(429, "RESOURCE_EXHAUSTED", "rate limited"),
                    {"Retry-After": "0"},
                )
            if self.fail_next_requests > 0:
                self.fail_next_requests -= 1
                return 500, _err(500, "INTERNAL", "injected transient failure"), {}
            self._settle_locked()

            m = _OP_RE.match(path)
            if m and method == "GET":
                op = self.ops.get(m.group("name"))
                if op is None:
                    return 404, _err(404, "NOT_FOUND", "no such operation"), {}
                return 200, op, {}

            m = _QR_RE.match(path)
            if m:
                parent = f"projects/{m.group('project')}/locations/{m.group('zone')}"
                qr_id = m.group("id")
                if method == "GET" and qr_id:
                    qr = self.qrs.get(qr_id)
                    if qr is None:
                        return 404, _err(404, "NOT_FOUND", f"no queued resource {qr_id}"), {}
                    return 200, qr, {}
                if method == "GET":
                    items = sorted(self.qrs.values(), key=lambda q: q["name"])
                    page_size = int(query.get("pageSize", ["100"])[0])
                    token = int(query.get("pageToken", ["0"])[0] or 0)
                    page = items[token : token + page_size]
                    out = {"queuedResources": page}
                    if token + page_size < len(items):
                        out["nextPageToken"] = str(token + page_size)
                    return 200, out, {}
                if method == "POST" and not qr_id:
                    want_id = query.get("queuedResourceId", [""])[0]
                    if not want_id:
                        return 400, _err(400, "INVALID_ARGUMENT", "queuedResourceId required"), {}
                    if want_id in self.qrs:
                        return 409, _err(409, "ALREADY_EXISTS", f"{want_id} exists"), {}
                    qr = dict(body or {})
                    qr["name"] = f"{parent}/queuedResources/{want_id}"
                    chips = self._chips_of(qr)
                    if self.fail_next_creates_async > 0:
                        self.fail_next_creates_async -= 1
                        qr["state"] = {"state": "FAILED"}
                        self.qrs[want_id] = qr
                        op = self._new_op(
                            parent,
                            done=True,
                            error={
                                "code": 13,
                                "status": "INTERNAL",
                                "message": "provisioning failed (injected)",
                            },
                        )
                        return 200, op, {}
                    if (
                        self.quota_chips is not None
                        and self._used_chips() + chips > self.quota_chips
                    ):
                        # Real surface: the POST is accepted, the OPERATION
                        # fails RESOURCE_EXHAUSTED (async quota denial).
                        qr["state"] = {"state": "FAILED"}
                        self.qrs[want_id] = qr
                        op = self._new_op(
                            parent,
                            done=True,
                            error={
                                "code": 8,
                                "status": "RESOURCE_EXHAUSTED",
                                "message": (
                                    f"quota exceeded: {chips} chips requested, "
                                    f"{max(0, self.quota_chips - self._used_chips() + chips)} available"
                                ),
                            },
                        )
                        return 200, op, {}
                    if self.provision_delay_s > 0:
                        qr["state"] = {"state": "PROVISIONING"}
                        self._ready_at[want_id] = time.monotonic() + self.provision_delay_s
                        self.qrs[want_id] = qr
                        return 200, self._new_op(parent, done=True), {}
                    qr["state"] = {"state": "ACTIVE"}
                    self.qrs[want_id] = qr
                    self._materialize_node_locked(want_id)
                    return 200, self._new_op(parent, done=True), {}
                if method == "DELETE" and qr_id:
                    if qr_id not in self.qrs:
                        return 404, _err(404, "NOT_FOUND", f"no queued resource {qr_id}"), {}
                    del self.qrs[qr_id]
                    self.node_labels.pop(qr_id, None)
                    self._ready_at.pop(qr_id, None)
                    return 200, self._new_op(parent, done=True), {}

            m = _NODE_RE.match(path)
            if m:
                parent = f"projects/{m.group('project')}/locations/{m.group('zone')}"
                node_id = m.group("id")
                if method == "GET" and not node_id:
                    items = [
                        {"name": f"{parent}/nodes/{nid}", "labels": dict(labels)}
                        for nid, labels in sorted(self.node_labels.items())
                    ]
                    page_size = int(query.get("pageSize", ["100"])[0])
                    token = int(query.get("pageToken", ["0"])[0] or 0)
                    out = {"nodes": items[token : token + page_size]}
                    if token + page_size < len(items):
                        out["nextPageToken"] = str(token + page_size)
                    return 200, out, {}
                if node_id and node_id not in self.node_labels:
                    return 404, _err(404, "NOT_FOUND", f"no node {node_id}"), {}
                if method == "GET" and node_id:
                    return 200, {
                        "name": f"{parent}/nodes/{node_id}",
                        "labels": dict(self.node_labels[node_id]),
                    }, {}
                if method == "PATCH" and node_id:
                    mask = query.get("updateMask", [""])[0]
                    if "labels" in mask.split(","):
                        # Mutates the NODE only; the queued resource's
                        # nodeSpec stays the creation-time echo.
                        self.node_labels[node_id].update(
                            (body or {}).get("labels", {})
                        )
                    return 200, self._new_op(parent, done=True), {}

            return 404, _err(404, "NOT_FOUND", f"no route {method} {path}"), {}


def _err(code: int, status: str, message: str) -> dict:
    return {"error": {"code": code, "status": status, "message": message}}


def _make_handler(server: FakeCloudTpuServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: D102 — silence test noise
            pass

        def _dispatch(self, method: str) -> None:
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                except ValueError:
                    body = None
            status, payload, extra = server.handle(
                method, parsed.path, query, body, dict(self.headers)
            )
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def do_PATCH(self):
            self._dispatch("PATCH")

    return Handler
