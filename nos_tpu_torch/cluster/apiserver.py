"""Port of `nos_tpu/cluster/apiserver.py` (:1-475): `ClusterAPIServer` (:101).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

A Kubernetes API server emulator over the in-memory cluster bus.

Serves the k8s REST surface (typed GET/LIST/POST/PUT/PATCH/DELETE, the status
subresource, label/field selectors, and chunked ``?watch=true`` event streams)
backed by ``cluster.client.Cluster``. This is the envtest analog for the HTTP
stack (reference test strategy, SURVEY §4: controller-runtime envtest spins a
real API server + etcd; here the store is the in-memory bus and the HTTP layer
is real), and doubles as the local control plane for ``make cluster``.

Admission: webhooks registered on the backing cluster run in-process (the
manager-embedded path); ``add_remote_webhook`` additionally forwards writes as
AdmissionReview v1 POSTs to an external webhook endpoint, mirroring a
ValidatingWebhookConfiguration (reference elasticquota_webhook.go:48-87 is
served by the operator's webhook server, not compiled into the API server).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from nos_tpu_torch.cluster.client import (
    AdmissionError,
    AlreadyExistsError,
    Cluster,
    ConflictError,
    Event,
    EventType,
    NotFoundError,
)
from nos_tpu_torch.cluster.serialize import KINDS, KINDS_BY_PLURAL, KindInfo, from_wire, to_wire

logger = logging.getLogger(__name__)


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps(
        {
            "apiVersion": "v1",
            "kind": "Status",
            "status": "Failure",
            "code": code,
            "reason": reason,
            "message": message,
        }
    ).encode()


def _merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch (strategic-merge is accepted but treated the
    same; the controllers only patch maps — labels, annotations, status)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out


def _parse_label_selector(sel: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in sel.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"unsupported label selector term {part!r}")
        k, _, v = part.partition("==") if "==" in part else part.partition("=")
        out[k.strip()] = v.strip()
    return out


def _field_get(wire: Dict[str, Any], path: str) -> Any:
    cur: Any = wire
    for seg in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(seg)
    return cur


class _Route:
    def __init__(self, info: KindInfo, namespace: str, name: str, subresource: str):
        self.info = info
        self.namespace = namespace
        self.name = name
        self.subresource = subresource


class ClusterAPIServer:
    """Serve `cluster` over HTTP on 127.0.0.1:`port` (0 = ephemeral)."""

    def __init__(self, cluster: Optional[Cluster] = None, port: int = 0):
        self.cluster = cluster if cluster is not None else Cluster()
        self._remote_webhooks: Dict[str, List[str]] = {}
        emulator = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802
                logger.debug("apiserver: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                emulator._handle(self, "GET")

            def do_POST(self):  # noqa: N802
                emulator._handle(self, "POST")

            def do_PUT(self):  # noqa: N802
                emulator._handle(self, "PUT")

            def do_PATCH(self):  # noqa: N802
                emulator._handle(self, "PATCH")

            def do_DELETE(self):  # noqa: N802
                emulator._handle(self, "DELETE")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ClusterAPIServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="apiserver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def write_kubeconfig(self, path: str) -> str:
        """Write a kubeconfig pointing at this emulator (kind-cluster analog of
        `kind get kubeconfig`)."""
        cfg = {
            "apiVersion": "v1",
            "kind": "Config",
            "clusters": [{"name": "nos-local", "cluster": {"server": self.url}}],
            "users": [{"name": "nos-local", "user": {}}],
            "contexts": [
                {"name": "nos-local", "context": {"cluster": "nos-local", "user": "nos-local"}}
            ],
            "current-context": "nos-local",
        }
        with open(path, "w") as f:
            json.dump(cfg, f)  # JSON is valid YAML
        return path

    # -- remote admission ----------------------------------------------------
    def add_remote_webhook(self, kind: str, url: str) -> None:
        """Register an external AdmissionReview v1 endpoint for `kind` writes
        (the ValidatingWebhookConfiguration seam)."""
        self._remote_webhooks.setdefault(kind, []).append(url)

    def _run_remote_webhooks(self, op: str, obj: Any, old: Optional[Any]) -> None:
        kind = getattr(obj, "KIND", type(obj).__name__)
        for url in self._remote_webhooks.get(kind, []):
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": "req-1",
                    "operation": "CREATE" if op == "CREATE" else "UPDATE",
                    "object": to_wire(obj),
                    "oldObject": to_wire(old) if old is not None else None,
                },
            }
            req = urllib.request.Request(
                url,
                data=json.dumps(review).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = json.loads(resp.read())
            response = body.get("response") or {}
            if not response.get("allowed", False):
                message = ((response.get("status") or {}).get("message")) or "denied"
                raise AdmissionError(message)

    # -- routing -------------------------------------------------------------
    def _route(self, path: str) -> Optional[_Route]:
        parts = [p for p in path.split("/") if p]
        # /api/v1/... or /apis/<group>/<version>/...
        if len(parts) >= 2 and parts[0] == "api" and parts[1] == "v1":
            rest = parts[2:]
        elif len(parts) >= 3 and parts[0] == "apis":
            rest = parts[3:]
        else:
            return None
        namespace = ""
        if len(rest) >= 2 and rest[0] == "namespaces":
            namespace = rest[1]
            rest = rest[2:]
        if not rest:
            return None
        info = KINDS_BY_PLURAL.get(rest[0])
        if info is None:
            return None
        name = rest[1] if len(rest) >= 2 else ""
        subresource = rest[2] if len(rest) >= 3 else ""
        return _Route(info, namespace, name, subresource)

    # -- request handling ----------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(req.path)
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        try:
            if parsed.path in ("/healthz", "/readyz", "/livez"):
                self._send(req, 200, b"ok", content_type="text/plain")
                return
            if parsed.path == "/version":
                self._send_json(req, 200, {"major": "1", "minor": "25", "gitVersion": "v1.25.4-nos-emulated"})
                return
            if parsed.path == "/api":
                self._send_json(req, 200, {"kind": "APIVersions", "versions": ["v1"]})
                return
            if parsed.path == "/apis":
                groups = sorted({i.group for i in KINDS.values() if i.group})
                self._send_json(
                    req, 200,
                    {"kind": "APIGroupList", "groups": [{"name": g} for g in groups]},
                )
                return
            route = self._route(parsed.path)
            if route is None:
                self._send(req, 404, _status_body(404, "NotFound", f"no route for {parsed.path}"))
                return
            if method == "GET" and not route.name and params.get("watch") in ("true", "1"):
                self._watch(req, route, params)
            elif method == "GET" and route.name:
                self._get(req, route)
            elif method == "GET":
                self._list(req, route, params)
            elif method == "POST" and not route.name:
                self._create(req, route)
            elif method == "PUT" and route.name:
                self._update(req, route)
            elif method == "PATCH" and route.name:
                self._patch(req, route)
            elif method == "DELETE" and route.name:
                self._delete(req, route)
            else:
                self._send(req, 405, _status_body(405, "MethodNotAllowed", method))
        except NotFoundError as e:
            self._send(req, 404, _status_body(404, "NotFound", str(e)))
        except AlreadyExistsError as e:
            self._send(req, 409, _status_body(409, "AlreadyExists", str(e)))
        except ConflictError as e:
            self._send(req, 409, _status_body(409, "Conflict", str(e)))
        except AdmissionError as e:
            self._send(req, 403, _status_body(403, "Forbidden", f"admission webhook denied: {e}"))
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("apiserver: %s %s failed", method, req.path)
            self._send(req, 500, _status_body(500, "InternalError", str(e)))

    def _read_body(self, req: BaseHTTPRequestHandler) -> Dict[str, Any]:
        length = int(req.headers.get("Content-Length") or 0)
        raw = req.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def _send(self, req, code: int, body: bytes, content_type: str = "application/json") -> None:
        try:
            req.send_response(code)
            req.send_header("Content-Type", content_type)
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_json(self, req, code: int, obj: Dict[str, Any]) -> None:
        self._send(req, code, json.dumps(obj).encode())

    # -- verbs ---------------------------------------------------------------
    def _get(self, req, route: _Route) -> None:
        obj = self.cluster.get(route.info.kind, route.namespace, route.name)
        self._send_json(req, 200, to_wire(obj))

    def _list(self, req, route: _Route, params: Dict[str, str]) -> None:
        selector = _parse_label_selector(params.get("labelSelector", ""))
        field_sel = _parse_label_selector(params.get("fieldSelector", ""))
        items = self.cluster.list(
            route.info.kind,
            namespace=route.namespace or None,
            label_selector=selector or None,
        )
        wires = [to_wire(o) for o in items]
        if field_sel:
            wires = [
                w
                for w in wires
                if all(str(_field_get(w, k)) == v for k, v in field_sel.items())
            ]
        self._send_json(
            req,
            200,
            {
                "apiVersion": "v1",
                "kind": f"{route.info.kind}List",
                "metadata": {"resourceVersion": str(self.cluster._rv)},
                "items": wires,
            },
        )

    def _create(self, req, route: _Route) -> None:
        wire = self._read_body(req)
        wire.setdefault("kind", route.info.kind)
        obj = route.info.from_wire(wire)
        if route.info.namespaced and route.namespace:
            obj.metadata.namespace = route.namespace
        obj.metadata.resource_version = 0
        self._run_remote_webhooks("CREATE", obj, None)
        stored = self.cluster.create(obj)
        self._send_json(req, 201, to_wire(stored))

    def _update(self, req, route: _Route) -> None:
        wire = self._read_body(req)
        wire.setdefault("kind", route.info.kind)
        incoming = route.info.from_wire(wire)
        if route.subresource == "status":
            # Status subresource: only .status moves; spec/meta stay.
            def apply_status(obj):
                obj.status = incoming.status
                if (
                    incoming.metadata.resource_version
                    and incoming.metadata.resource_version != obj.metadata.resource_version
                ):
                    raise ConflictError(
                        f"status update rv {incoming.metadata.resource_version} "
                        f"!= {obj.metadata.resource_version}"
                    )

            stored = self.cluster.patch(
                route.info.kind, route.namespace, route.name, apply_status
            )
        else:
            if route.info.has_status_subresource:
                current = self.cluster.get(route.info.kind, route.namespace, route.name)
                incoming.status = current.status  # main PUT cannot move status
            old = self.cluster.try_get(route.info.kind, route.namespace, route.name)
            self._run_remote_webhooks("UPDATE", incoming, old)
            stored = self.cluster.update(incoming)
        self._send_json(req, 200, to_wire(stored))

    def _patch(self, req, route: _Route) -> None:
        patch = self._read_body(req)
        info = route.info
        is_status = route.subresource == "status"

        def apply(obj):
            wire = to_wire(obj)
            if is_status:
                merged = dict(wire)
                merged["status"] = _merge_patch(wire.get("status") or {}, patch.get("status") or {})
            else:
                claimed_rv = (patch.get("metadata") or {}).get("resourceVersion")
                actual_rv = (wire.get("metadata") or {}).get("resourceVersion")
                if claimed_rv is not None and str(claimed_rv) != str(actual_rv):
                    raise ConflictError(
                        f"merge patch rv {claimed_rv} != {actual_rv} for "
                        f"{info.kind} {route.namespace}/{route.name}"
                    )
                merged = _merge_patch(wire, patch)
                if info.has_status_subresource:
                    merged["status"] = wire.get("status")
                # identity + bookkeeping fields are server-owned
                for k in ("resourceVersion", "uid", "creationTimestamp"):
                    merged.setdefault("metadata", {})[k] = (wire.get("metadata") or {}).get(k)
                merged["metadata"]["name"] = (wire.get("metadata") or {}).get("name")
                merged["metadata"]["namespace"] = (wire.get("metadata") or {}).get("namespace")
            new_obj = info.from_wire(merged)
            obj.metadata = new_obj.metadata
            for attr in ("spec", "status", "data", "owner_references"):
                if hasattr(obj, attr):
                    setattr(obj, attr, getattr(new_obj, attr))

        old = self.cluster.try_get(info.kind, route.namespace, route.name)
        if old is not None and not is_status:
            preview = old.deepcopy() if hasattr(old, "deepcopy") else old
            apply(preview)
            self._run_remote_webhooks("UPDATE", preview, old)
        stored = self.cluster.patch(info.kind, route.namespace, route.name, apply)
        self._send_json(req, 200, to_wire(stored))

    def _delete(self, req, route: _Route) -> None:
        obj = self.cluster.get(route.info.kind, route.namespace, route.name)
        self.cluster.delete(route.info.kind, route.namespace, route.name)
        self._send_json(req, 200, to_wire(obj))

    # -- watch ---------------------------------------------------------------
    def _watch(self, req, route: _Route, params: Dict[str, str]) -> None:
        selector = _parse_label_selector(params.get("labelSelector", ""))
        rv = params.get("resourceVersion", "")
        replay = rv in ("", "0")
        q: "queue.Queue[Optional[Event]]" = queue.Queue()

        def matches(obj) -> bool:
            if route.namespace and obj.metadata.namespace != route.namespace:
                return False
            if selector and any(
                obj.metadata.labels.get(k) != v for k, v in selector.items()
            ):
                return False
            return True

        def on_event(ev: Event) -> None:
            if matches(ev.obj):
                q.put(ev)

        unsub = self.cluster.watch(route.info.kind, on_event, replay=replay)
        if not replay:
            # Close the LIST->WATCH gap: re-deliver anything committed after
            # the client's resourceVersion as ADDED (the store keeps no event
            # history; clients dedupe by rv, so over-delivery is safe while
            # under-delivery loses events until the next relist).
            try:
                since = int(rv)
            except ValueError:
                since = 0
            for obj in self.cluster.list(route.info.kind):
                if obj.metadata.resource_version > since and matches(obj):
                    q.put(Event(EventType.ADDED, obj))
        try:
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
            req.send_header("Transfer-Encoding", "chunked")
            req.end_headers()

            timeout_s = float(params.get("timeoutSeconds", "0") or 0)
            import time as _time

            deadline = _time.monotonic() + timeout_s if timeout_s else None
            while True:
                wait = 1.0
                if deadline is not None:
                    wait = min(wait, deadline - _time.monotonic())
                    if wait <= 0:
                        break
                try:
                    ev = q.get(timeout=wait)
                except queue.Empty:
                    continue
                line = json.dumps({"type": ev.type, "object": to_wire(ev.obj)}).encode() + b"\n"
                chunk = f"{len(line):x}\r\n".encode() + line + b"\r\n"
                req.wfile.write(chunk)
                req.wfile.flush()
            req.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            unsub()
