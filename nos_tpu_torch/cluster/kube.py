"""Port of `nos_tpu/cluster/kube.py` (:1-657): `ApiError` (:52), `KubeConfig`
(:60), `compute_merge_patch` (:175), `KubeCluster` (:343). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package.

A real-Kubernetes cluster backend speaking the same protocol as the
in-memory bus.

``KubeCluster`` implements the ``Cluster`` surface (create/update/patch/
delete/get/try_get/list/watch/register_webhook) over the Kubernetes REST API
using only the standard library (http.client + ssl + yaml for kubeconfig):
the image ships no kubernetes client package, and the API is plain JSON/REST.
Controllers built against ``cluster.client.Cluster`` run unmodified against a
kind/GKE cluster through this class — the reference's controller-runtime
client seam (SURVEY §2.3/§5 "distributed communication backend").

Watch semantics: one background informer thread per watched kind performs
LIST+WATCH with reconnect; because k8s watch events carry only the new object,
the informer keeps a local cache to synthesize ``Event.old_obj`` for MODIFIED
events (client-go's OnUpdate(old, new) contract, which the quota reconciler's
phase-transition predicate needs — elasticquota_controller.go:144-163).

Webhooks: ``register_webhook`` records the hook; enforcement happens when an
``AdmissionWebhookServer`` (cluster/webhook_server.py) serves the registry to
the API server via a ValidatingWebhookConfiguration — the reference's
SetupWebhookWithManager split, where validation logic lives in the operator,
not the API server.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import tempfile
import threading
import time
from http.client import HTTPConnection, HTTPException, HTTPSConnection
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, urlparse

from nos_tpu_torch.cluster.client import (
    AdmissionError,
    AlreadyExistsError,
    ConflictError,
    Event,
    EventType,
    NotFoundError,
)
from nos_tpu_torch.cluster.serialize import KINDS, KindInfo, to_wire

logger = logging.getLogger(__name__)


class ApiError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{code} {reason}: {message}")
        self.code = code
        self.reason = reason
        self.message = message


class KubeConfig:
    """Minimal kubeconfig model: server URL, TLS material, bearer token."""

    def __init__(
        self,
        server: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        ca_data: Optional[str] = None,
        client_cert_file: Optional[str] = None,
        client_key_file: Optional[str] = None,
        client_cert_data: Optional[str] = None,
        client_key_data: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
    ):
        self.server = server.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.ca_data = ca_data
        self.client_cert_file = client_cert_file
        self.client_key_file = client_key_file
        self.client_cert_data = client_cert_data
        self.client_key_data = client_key_data
        self.insecure_skip_tls_verify = insecure_skip_tls_verify

    @classmethod
    def load(cls, path: Optional[str] = None) -> "KubeConfig":
        """Load from `path`, $KUBECONFIG, or ~/.kube/config; falls back to
        in-cluster service-account config when none exists."""
        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        if not os.path.exists(path):
            return cls._load_in_cluster()
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        contexts = {c["name"]: c["context"] for c in raw.get("contexts") or []}
        clusters = {c["name"]: c["cluster"] for c in raw.get("clusters") or []}
        users = {u["name"]: u.get("user") or {} for u in raw.get("users") or []}
        ctx_name = raw.get("current-context") or (next(iter(contexts)) if contexts else "")
        ctx = contexts.get(ctx_name) or {}
        cluster = clusters.get(ctx.get("cluster", "")) or {}
        user = users.get(ctx.get("user", "")) or {}
        return cls(
            server=cluster.get("server", "http://127.0.0.1:8080"),
            token=user.get("token"),
            ca_file=cluster.get("certificate-authority"),
            ca_data=cluster.get("certificate-authority-data"),
            client_cert_file=user.get("client-certificate"),
            client_key_file=user.get("client-key"),
            client_cert_data=user.get("client-certificate-data"),
            client_key_data=user.get("client-key-data"),
            insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        )

    @classmethod
    def _load_in_cluster(cls) -> "KubeConfig":
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise FileNotFoundError(
                "no kubeconfig found and not running in-cluster "
                "(KUBERNETES_SERVICE_HOST unset)"
            )
        token = None
        token_path = os.path.join(sa, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        return cls(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(sa, "ca.crt") if os.path.exists(os.path.join(sa, "ca.crt")) else None,
        )

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if self.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.ca_data:
            ctx.load_verify_locations(cadata=base64.b64decode(self.ca_data).decode())
        elif self.ca_file:
            ctx.load_verify_locations(cafile=self.ca_file)
        cert_file, key_file = self.client_cert_file, self.client_key_file
        materialized: list = []
        if self.client_cert_data and self.client_key_data:
            # ssl wants files; materialize the -data variants, then unlink —
            # load_cert_chain reads eagerly, and key material must not linger
            # in /tmp.
            cert_file = self._tmp(base64.b64decode(self.client_cert_data))
            key_file = self._tmp(base64.b64decode(self.client_key_data))
            materialized = [cert_file, key_file]
        try:
            if cert_file and key_file:
                ctx.load_cert_chain(certfile=cert_file, keyfile=key_file)
        finally:
            for path in materialized:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        return ctx

    @staticmethod
    def _tmp(data: bytes) -> str:
        f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
        f.write(data)
        f.close()
        return f.name


def compute_merge_patch(old: Any, new: Any) -> Optional[Any]:
    """RFC 7386 merge patch turning `old` into `new`; None when identical."""
    if isinstance(old, dict) and isinstance(new, dict):
        patch: Dict[str, Any] = {}
        for k, nv in new.items():
            if k not in old:
                patch[k] = nv
            else:
                sub = compute_merge_patch(old[k], nv)
                if sub is not None:
                    patch[k] = sub
        for k in old:
            if k not in new:
                patch[k] = None
        return patch or None
    if old == new:
        return None
    return new


class _Informer:
    """LIST+WATCH loop for one kind, with a cache for old_obj synthesis."""

    def __init__(self, kube: "KubeCluster", info: KindInfo):
        self.kube = kube
        self.info = info
        self.handlers: List[Tuple[Callable[[Event], None], bool]] = []
        self.cache: Dict[Tuple[str, str], Any] = {}
        self.lock = threading.Lock()
        self.stopped = threading.Event()
        self.synced = threading.Event()
        self._conn = None
        self.thread = threading.Thread(
            target=self._run, name=f"informer-{info.kind}", daemon=True
        )

    def add_handler(self, handler: Callable[[Event], None], replay: bool) -> None:
        # Register before replaying: a live event racing the replay produces a
        # duplicate delivery, never a miss (reconcilers are level-triggered).
        with self.lock:
            snapshot = list(self.cache.values())
            self.handlers.append((handler, replay))
        if replay:
            for obj in snapshot:
                self._safe(handler, Event(EventType.ADDED, obj))

    def remove_handler(self, handler: Callable[[Event], None]) -> None:
        with self.lock:
            self.handlers = [(h, r) for h, r in self.handlers if h is not handler]

    def stop(self) -> None:
        self.stopped.set()
        conn = self._conn
        if conn is not None:
            # Hard-close the socket: HTTPResponse.close() would block draining
            # the still-open chunked watch stream.
            try:
                if conn.sock is not None:
                    import socket as _socket

                    conn.sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except (OSError, HTTPException):
                pass

    @staticmethod
    def _safe(handler, ev: Event) -> None:
        try:
            handler(ev)
        except Exception:  # noqa: BLE001
            logger.exception("watch handler failed for %s %s", ev.type, type(ev.obj).__name__)

    def _dispatch(self, ev: Event) -> None:
        self.kube._bump_version()
        with self.lock:
            handlers = [h for h, _ in self.handlers]
        for h in handlers:
            self._safe(h, ev)

    def _run(self) -> None:
        backoff = 0.2
        while not self.stopped.is_set():
            try:
                rv = self._relist()
                self.synced.set()
                backoff = 0.2
                self._watch_stream(rv)
            except Exception as e:  # noqa: BLE001
                if self.stopped.is_set():
                    return
                logger.debug("informer %s: reconnect after %r", self.info.kind, e)
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    def _relist(self) -> str:
        wires, list_rv = self.kube._list_wire(self.info)
        fresh: Dict[Tuple[str, str], Any] = {}
        for w in wires:
            obj = self.info.from_wire(w)
            fresh[(obj.metadata.namespace, obj.metadata.name)] = obj
        with self.lock:
            old_cache = dict(self.cache)
            self.cache = fresh
        # Synthesize the delta the dropped watch missed (client-go replays the
        # store the same way on re-sync).
        for key, obj in fresh.items():
            old = old_cache.get(key)
            if old is None:
                self._dispatch(Event(EventType.ADDED, obj))
            elif old.metadata.resource_version != obj.metadata.resource_version:
                self._dispatch(Event(EventType.MODIFIED, obj, old))
        for key, old in old_cache.items():
            if key not in fresh:
                self._dispatch(Event(EventType.DELETED, old))
        return list_rv

    def _watch_stream(self, rv: str) -> None:
        path = self.info.path_for() + f"?watch=true&resourceVersion={quote(rv)}&timeoutSeconds=300"
        conn, resp = self.kube._open_stream(path)
        self._conn = conn
        try:
            while not self.stopped.is_set():
                line = resp.readline()
                if not line:
                    return  # server-side timeout; caller re-lists
                line = line.strip()
                if not line:
                    continue
                msg = json.loads(line)
                if msg.get("type") == "BOOKMARK":
                    continue
                if msg.get("type") == "ERROR":
                    raise ApiError(410, "Expired", json.dumps(msg.get("object") or {}))
                obj = self.info.from_wire(msg["object"])
                key = (obj.metadata.namespace, obj.metadata.name)
                with self.lock:
                    old = self.cache.get(key)
                    if msg["type"] == "DELETED":
                        self.cache.pop(key, None)
                    else:
                        self.cache[key] = obj
                if msg["type"] == "ADDED" and old is not None:
                    # replayed ADDED after reconnect: demote to MODIFIED/no-op
                    if old.metadata.resource_version == obj.metadata.resource_version:
                        continue
                    self._dispatch(Event(EventType.MODIFIED, obj, old))
                elif msg["type"] == "MODIFIED":
                    self._dispatch(Event(EventType.MODIFIED, obj, old))
                else:
                    self._dispatch(Event(msg["type"], obj, old))
        finally:
            self._conn = None
            try:
                if conn.sock is not None:
                    import socket as _socket

                    conn.sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except (OSError, HTTPException):
                pass


class KubeCluster:
    """The Cluster protocol over a real Kubernetes API server."""

    def __init__(self, config: Optional[KubeConfig] = None, kubeconfig_path: Optional[str] = None):
        self.config = config or KubeConfig.load(kubeconfig_path)
        parsed = urlparse(self.config.server)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self._scheme = parsed.scheme or "http"
        self._ssl = self.config.ssl_context()
        self._informers: Dict[str, _Informer] = {}
        self._informer_lock = threading.Lock()
        self._local = threading.local()  # persistent per-thread connection
        self.webhooks: Dict[str, List[Callable[[str, Any, Optional[Any]], None]]] = {}
        self._version_lock = threading.Lock()
        self._version = 0

    # -- change signal -------------------------------------------------------
    @property
    def version(self) -> int:
        """Protocol parity with the in-memory Cluster's `version`, minus the
        guarantee: a remote API server mutates underneath us in ways only a
        full informer set would observe, so there is no sound "nothing
        changed" signal here. Each read returns a fresh value, so pollers'
        version fast paths never engage against the real backend (they keep
        their full recompute semantics); the counter still advances on local
        writes and informer events for observability."""
        with self._version_lock:
            self._version += 1
            return self._version

    def _bump_version(self) -> None:
        with self._version_lock:
            self._version += 1

    def peek(self, kind: str, namespace: str, name: str, fn: Callable[[Any], Any]) -> Any:
        """Protocol parity with the in-memory Cluster: apply a read-only
        extractor to the object, or None when absent. Remote reads already
        materialize a fresh object, so this is try_get + apply."""
        obj = self.try_get(kind, namespace, name)
        return None if obj is None else fn(obj)

    # -- transport -----------------------------------------------------------
    def _connect(self):
        if self._scheme == "https":
            return HTTPSConnection(self._host, self._port, context=self._ssl, timeout=30)
        return HTTPConnection(self._host, self._port, timeout=30)

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        h = {"Accept": "application/json"}
        if content_type:
            h["Content-Type"] = content_type
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        return h

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        content_type: str = "application/json",
    ) -> Dict[str, Any]:
        """One REST exchange over a persistent per-thread connection (a fresh
        TCP+TLS handshake per call would triple the cost of every patch on
        the reconcile hot path); a dead keep-alive connection gets one retry
        on a fresh one."""
        payload = json.dumps(body).encode() if body is not None else None
        headers = self._headers(content_type)
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            reused = conn is not None
            if conn is None:
                conn = self._connect()
                self._local.conn = conn
            sent = False
            try:
                conn.request(method, path, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, HTTPException):
                self._local.conn = None
                try:
                    conn.close()
                except (OSError, HTTPException):
                    pass
                # Retry only when it cannot double-apply: idempotent reads, or
                # a send-phase failure on a stale keep-alive connection (the
                # request never reached the server). A non-idempotent request
                # that died after send may already be committed server-side —
                # surface the error instead of re-sending it.
                safe = method == "GET" or (reused and not sent)
                if attempt or not safe:
                    raise
                continue
            if resp.status >= 400:
                self._raise_for(resp.status, raw)
            return json.loads(raw) if raw else {}
        raise RuntimeError("unreachable")

    def _open_stream(self, path: str):
        conn = self._connect()
        conn.timeout = 330  # outlive the server-side watch timeout
        conn.request("GET", path, headers=self._headers())
        resp = conn.getresponse()
        if resp.status >= 400:
            raw = resp.read()
            conn.close()
            self._raise_for(resp.status, raw)
        return conn, resp

    @staticmethod
    def _raise_for(status: int, raw: bytes) -> None:
        try:
            body = json.loads(raw)
            reason = body.get("reason", "")
            message = body.get("message", raw.decode(errors="replace"))
        except (ValueError, AttributeError):
            # Not a JSON Status object (proxy error page, truncated body):
            # fall back to the raw text.
            reason, message = "", raw.decode(errors="replace")
        if status == 404:
            raise NotFoundError(message)
        if status == 409 and reason == "AlreadyExists":
            raise AlreadyExistsError(message)
        if status == 409:
            raise ConflictError(message)
        if status in (400, 403, 422) and (
            "admission" in message.lower() or "denied" in message.lower()
        ):
            raise AdmissionError(message)
        # Plain 403s (RBAC denials etc.) stay ApiError: misreporting them as
        # webhook rejections would mask deployment misconfiguration.
        raise ApiError(status, reason, message)

    @staticmethod
    def _info(kind: str) -> KindInfo:
        info = KINDS.get(kind)
        if info is None:
            raise ValueError(f"unknown kind {kind!r}")
        return info

    # -- Cluster protocol: writes -------------------------------------------
    def create(self, obj: Any) -> Any:
        info = self._info(getattr(obj, "KIND", type(obj).__name__))
        wire = to_wire(obj)
        wire.get("metadata", {}).pop("resourceVersion", None)
        wire.get("metadata", {}).pop("uid", None)
        wire.get("metadata", {}).pop("creationTimestamp", None)
        out = self._request("POST", info.path_for(obj.metadata.namespace), wire)
        stored = info.from_wire(out)
        # k8s ignores status on create for subresourced kinds; push it only
        # when it differs from what the server defaulted (skips a round trip
        # on the hot create path — most creates carry a default status).
        if info.has_status_subresource:
            desired_status = wire.get("status")
            stored_status = to_wire(stored).get("status")
            if desired_status and desired_status != stored_status:
                status_wire = to_wire(stored)
                status_wire["status"] = desired_status
                out = self._request(
                    "PUT",
                    info.path_for(obj.metadata.namespace, obj.metadata.name) + "/status",
                    status_wire,
                )
                stored = info.from_wire(out)
        self._bump_version()
        return stored

    def update(self, obj: Any) -> Any:
        info = self._info(getattr(obj, "KIND", type(obj).__name__))
        path = info.path_for(obj.metadata.namespace, obj.metadata.name)
        wire = to_wire(obj)
        out = self._request("PUT", path, wire)
        stored = info.from_wire(out)
        if info.has_status_subresource:
            current_status = to_wire(stored).get("status")
            desired_status = wire.get("status")
            if desired_status is not None and desired_status != current_status:
                status_wire = to_wire(stored)
                status_wire["status"] = desired_status
                out = self._request("PUT", path + "/status", status_wire)
                stored = info.from_wire(out)
        self._bump_version()
        return stored

    def patch(self, kind: str, namespace: str, name: str, fn: Callable[[Any], None]) -> Any:
        info = self._info(kind)
        path = info.path_for(namespace, name)
        last_err: Optional[Exception] = None
        for _ in range(5):
            current = self.get(kind, namespace, name)
            desired = current.deepcopy() if hasattr(current, "deepcopy") else current
            fn(desired)
            if (
                desired.metadata.namespace != current.metadata.namespace
                or desired.metadata.name != current.metadata.name
            ):
                raise ValueError(f"patch must not change object identity {(kind, namespace, name)}")
            cur_wire, new_wire = to_wire(current), to_wire(desired)
            cur_status, new_status = cur_wire.pop("status", None), new_wire.pop("status", None)
            main_patch = compute_merge_patch(cur_wire, new_wire)
            status_patch = compute_merge_patch(cur_status, new_status)
            if main_patch is None and status_patch is None:
                return current
            try:
                stored = current
                if main_patch is not None:
                    # include rv for optimistic concurrency against racers
                    main_patch.setdefault("metadata", {})["resourceVersion"] = str(
                        current.metadata.resource_version
                    )
                    out = self._request(
                        "PATCH", path, main_patch, content_type="application/merge-patch+json"
                    )
                    stored = info.from_wire(out)
                if status_patch is not None:
                    status_path = path + ("/status" if info.has_status_subresource else "")
                    out = self._request(
                        "PATCH",
                        status_path,
                        {"status": status_patch},
                        content_type="application/merge-patch+json",
                    )
                    stored = info.from_wire(out)
                self._bump_version()
                return stored
            except ConflictError as e:
                last_err = e
                time.sleep(0.05)
        raise last_err  # type: ignore[misc]

    def delete(self, kind: str, namespace: str, name: str) -> None:
        info = self._info(kind)
        self._request("DELETE", info.path_for(namespace, name))
        self._bump_version()

    # -- Cluster protocol: reads --------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Any:
        info = self._info(kind)
        return info.from_wire(self._request("GET", info.path_for(namespace, name)))

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def _list_wire(
        self,
        info: KindInfo,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Dict[str, Any]], str]:
        path = info.path_for(namespace or "")
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
            path += f"?labelSelector={quote(sel)}"
        out = self._request("GET", path)
        rv = str((out.get("metadata") or {}).get("resourceVersion") or "0")
        return list(out.get("items") or []), rv

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        predicate: Optional[Callable[[Any], bool]] = None,
    ) -> List[Any]:
        info = self._info(kind)
        wires, _ = self._list_wire(info, namespace, label_selector)
        out = [info.from_wire(w) for w in wires]
        if predicate is not None:
            out = [o for o in out if predicate(o)]
        out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        return out

    # -- Cluster protocol: watch / webhooks ---------------------------------
    def watch(
        self, kind: str, handler: Callable[[Event], None], replay: bool = True
    ) -> Callable[[], None]:
        info = self._info(kind)
        with self._informer_lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = _Informer(self, info)
                self._informers[kind] = inf
                inf.thread.start()
        # Wait for cache sync outside the lock: informers are independent and
        # an unreachable API server must not serialize other registrations.
        if not inf.synced.wait(timeout=30):
            logger.warning(
                "informer for %s not synced after 30s; proceeding with empty cache",
                kind,
            )
        inf.add_handler(handler, replay)

        def unsubscribe() -> None:
            inf.remove_handler(handler)

        return unsubscribe

    def register_webhook(self, kind: str, hook: Callable[[str, Any, Optional[Any]], None]) -> None:
        """Hooks land in a registry served by AdmissionWebhookServer; they are
        NOT enforced client-side (a real API server enforces via a
        ValidatingWebhookConfiguration pointing at that server)."""
        self.webhooks.setdefault(kind, []).append(hook)

    def close(self) -> None:
        with self._informer_lock:
            informers = list(self._informers.values())
            self._informers.clear()
        for inf in informers:
            inf.stop()
