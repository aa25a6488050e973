"""Port of `nos_tpu/tpulib/cloud.py` (:1-478): `CloudApiError` (:71),
`QuotaExhaustedError` (:81), `ProvisioningError` (:85),
`ProvisioningTimeout` (:89), `CloudTpuClient` (:107). Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

A real-infrastructure TPU carve backend over the Cloud TPU REST surface.

``CloudTpuClient`` implements the ``TpuClient`` protocol (tpulib/interface.py)
by driving a Cloud-TPU-v2-shaped provisioning API — the `queuedResources`
lifecycle GKE/GCE TPU capacity is actually carved through — instead of
mutating in-process state. It is the carve-path analog of what
``cluster/kube.py`` is for the control plane: a from-scratch stdlib REST
client (http.client + json only), anchored to the DOCUMENTED wire contract
and developed against golden fixtures + a fault-injecting fake server
(tpulib/cloud_server.py, tests/test_cloud_tpulib.py).

Reference anchor: pkg/gpu/nvml/client.go:225-340 — the layer of the reference
that manipulates real devices (NVML GI/CI creation with permutation retry).
This backend mirrors its realness the TPU-native way: sub-slice creation is a
queued-resource POST + long-running-operation poll, deletion is DELETE+poll,
and the in-use mark round-trips through node labels — all failure modes of a
real provisioning surface (quota exhaustion, slow provisioning, partial
failure, transient 429/5xx) are first-class here, not afterthoughts.

Wire shapes used (Cloud TPU v2, documented public surface):
  POST   {base}/v2/projects/{p}/locations/{z}/queuedResources?queuedResourceId={id}
           -> google.longrunning.Operation {name, done, error?, response?}
  GET    {base}/v2/{operation-name}
  GET    {base}/v2/projects/{p}/locations/{z}/queuedResources?pageSize&pageToken
           -> {queuedResources: [...], nextPageToken?}
  GET    {base}/v2/projects/{p}/locations/{z}/queuedResources/{id}
  DELETE {base}/v2/projects/{p}/locations/{z}/queuedResources/{id}?force=true
  PATCH  {base}/v2/projects/{p}/locations/{z}/nodes/{id}?updateMask=labels
  errors -> {"error": {"code": int, "message": str, "status": "RESOURCE_EXHAUSTED"|...}}

What runs real vs modeled (docs/tpulib.md): this client's wire behavior is
real and fixture-tested; in CI it talks to the in-process fake server (no
cloud credentials in the test environment), exactly as the kube backend is
CI-tested against the apiserver emulator + spec-shaped fixtures.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import time
from http.client import HTTPConnection, HTTPException, HTTPSConnection
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, urlencode, urlparse

from nos_tpu_torch.tpu import Profile, Topology
from nos_tpu_torch.tpulib.interface import SliceHandle, TpuLibError

logger = logging.getLogger(__name__)

# Labels carried on the queued resource's node spec: the carve geometry must
# round-trip through the provisioning surface the same way MIG geometry
# round-trips through device metadata (the control plane re-derives its whole
# model from list_slices()).
LABEL_MANAGED = "nos-tpu-managed"
LABEL_PROFILE = "nos-tpu-profile"
LABEL_ORIGIN = "nos-tpu-origin"
LABEL_DIMS = "nos-tpu-dims"
LABEL_IN_USE = "nos-tpu-in-use"

# Queued-resource states that count as a live slice. CREATING/ACCEPTED/
# PROVISIONING are in-flight (create_slice blocks until ACTIVE); FAILED and
# SUSPENDED are dead capacity the lister must not present as carveable.
_LIVE_STATES = ("ACTIVE",)
_PENDING_STATES = ("CREATING", "ACCEPTED", "PROVISIONING", "WAITING_FOR_RESOURCES")


class CloudApiError(TpuLibError):
    """HTTP-level failure from the provisioning surface."""

    def __init__(self, code: int, status: str, message: str):
        super().__init__(f"{code} {status}: {message}")
        self.code = code
        self.status = status
        self.message = message


class QuotaExhaustedError(CloudApiError):
    """RESOURCE_EXHAUSTED: the project/zone cannot host the requested chips."""


class ProvisioningError(TpuLibError):
    """The queued resource reached a terminal non-ACTIVE state."""


class ProvisioningTimeout(TpuLibError):
    """The operation did not complete within provision_timeout_s."""


def _env_token() -> Optional[str]:
    """Default auth: a bearer token from the environment or a token file —
    no cloud SDK dependency (the image ships none); real deployments inject
    the token the same way kubeconfig injects its bearer token."""
    token = os.environ.get("NOS_TPU_CLOUD_TOKEN")
    if token:
        return token
    path = os.environ.get("NOS_TPU_CLOUD_TOKEN_FILE")
    if path and os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    return None


class CloudTpuClient:
    """TpuClient over a Cloud-TPU-v2-shaped provisioning API.

    One client manages the sub-slices of one logical mesh (`topology`): each
    carved sub-slice is one queued resource whose node spec carries the
    geometry labels. `accelerator_type_fn` maps a profile to the API's
    accelerator type string (default: v5litepod-<chips>).
    """

    def __init__(
        self,
        topology: Topology,
        project: str,
        zone: str,
        base_url: str = "https://tpu.googleapis.com",
        token_provider: Callable[[], Optional[str]] = _env_token,
        runtime_version: str = "tpu-ubuntu2204-base",
        accelerator_type_fn: Optional[Callable[[Profile], str]] = None,
        provision_timeout_s: float = 300.0,
        poll_interval_s: float = 1.0,
        max_retries: int = 4,
        retry_backoff_s: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        http_timeout_s: float = 30.0,
    ):
        self._topology = topology
        self.project = project
        self.zone = zone
        self.base_url = base_url.rstrip("/")
        self.token_provider = token_provider
        self.runtime_version = runtime_version
        self.accelerator_type_fn = accelerator_type_fn or self._default_accel_type
        self.provision_timeout_s = provision_timeout_s
        self.poll_interval_s = poll_interval_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._sleep = sleep
        self.http_timeout_s = http_timeout_s
        self._lock = threading.RLock()
        self._counter = 0

    # -- naming ---------------------------------------------------------------
    @property
    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    def _qr_path(self, slice_id: str = "") -> str:
        base = f"/v2/{self._parent}/queuedResources"
        return f"{base}/{quote(slice_id)}" if slice_id else base

    def _node_path(self, slice_id: str) -> str:
        return f"/v2/{self._parent}/nodes/{quote(slice_id)}"

    @staticmethod
    def _default_accel_type(profile: Profile) -> str:
        return f"v5litepod-{profile.chips}"

    # -- HTTP -----------------------------------------------------------------
    def _connect(self):
        parsed = urlparse(self.base_url)
        host = parsed.hostname or "localhost"
        port = parsed.port
        if parsed.scheme == "https":
            return HTTPSConnection(
                host, port or 443, timeout=self.http_timeout_s,
                context=ssl.create_default_context(),
            )
        return HTTPConnection(host, port or 80, timeout=self.http_timeout_s)

    def _request(
        self, method: str, path: str, params: Optional[dict] = None,
        body: Optional[dict] = None,
    ) -> dict:
        """One API call with bounded retry on transient failures (429 and
        5xx, honoring Retry-After; connection errors count too). Non-retryable
        errors map to typed exceptions per the google.rpc status."""
        if params:
            path = f"{path}?{urlencode(params)}"
        headers = {"Accept": "application/json"}
        token = self.token_provider()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        payload = None
        if body is not None:
            payload = json.dumps(body)
            headers["Content-Type"] = "application/json"
        last_err: Optional[Exception] = None
        backoff_next = 0.0
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._sleep(backoff_next)
            # A server-provided Retry-After REPLACES this default for the
            # next wait (honoring it and then also sleeping the exponential
            # backoff would double every rate-limited delay).
            backoff_next = self.retry_backoff_s * (2 ** attempt)
            conn = self._connect()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status == 429 or resp.status >= 500:
                    retry_after = resp.getheader("Retry-After")
                    if retry_after:
                        try:
                            backoff_next = float(retry_after)
                        except ValueError:
                            pass
                    last_err = self._to_error(resp.status, raw)
                    continue
                if resp.status >= 400:
                    raise self._to_error(resp.status, raw)
                return json.loads(raw) if raw else {}
            except (HTTPException, OSError) as exc:
                last_err = exc
                continue
            finally:
                conn.close()
        if isinstance(last_err, TpuLibError):
            raise last_err
        raise TpuLibError(f"cloud tpu API unreachable after retries: {last_err}")

    @staticmethod
    def _to_error(code: int, raw: bytes) -> CloudApiError:
        status, message = "UNKNOWN", raw.decode(errors="replace")[:200]
        try:
            err = json.loads(raw).get("error", {})
            status = err.get("status", status)
            message = err.get("message", message)
        except (ValueError, AttributeError):
            pass
        # QuotaExhaustedError means "the zone cannot host these chips" — a
        # capacity decision callers may act on durably. The API uses 429 +
        # RESOURCE_EXHAUSTED for plain rate limiting too, so only a quota
        # message qualifies; a throttle stays a retryable CloudApiError.
        if status == "RESOURCE_EXHAUSTED" and "quota" in message.lower():
            return QuotaExhaustedError(code, status, message)
        return CloudApiError(code, status, message)

    # -- long-running operations ----------------------------------------------
    def _wait_operation(self, op: dict, what: str) -> dict:
        """Poll a google.longrunning.Operation until done or the provisioning
        deadline. An operation error surfaces as the matching typed error
        (quota -> QuotaExhaustedError) so callers see ONE failure taxonomy
        whether the API failed fast (HTTP error) or slow (async error)."""
        deadline = time.monotonic() + self.provision_timeout_s
        while not op.get("done"):
            if time.monotonic() >= deadline:
                raise ProvisioningTimeout(
                    f"{what}: operation {op.get('name')} still pending after "
                    f"{self.provision_timeout_s}s"
                )
            self._sleep(self.poll_interval_s)
            op = self._request("GET", f"/v2/{op['name']}")
        err = op.get("error")
        if err:
            code = int(err.get("code", 2))
            status = err.get("status", "")
            message = err.get("message", "")
            if code == 8 or status == "RESOURCE_EXHAUSTED" or "quota" in message.lower():
                raise QuotaExhaustedError(429, "RESOURCE_EXHAUSTED", message)
            raise ProvisioningError(f"{what}: {message or err}")
        return op

    # -- wire <-> handle ------------------------------------------------------
    def _node_of(self, qr: dict) -> dict:
        specs = qr.get("tpu", {}).get("nodeSpec", [])
        return specs[0].get("node", {}) if specs else {}

    def _handle_of(
        self, qr: dict, node_labels: Optional[dict] = None
    ) -> Optional[SliceHandle]:
        """Map a queued resource (+ its provisioned Node's labels) to a
        handle. Geometry comes from the CREATION-time nodeSpec labels, which
        the API echoes back verbatim forever; the mutable in-use mark must
        come from the live Node — a PATCH to /nodes/{id} does NOT write back
        into the queued resource's spec, so reading in-use from the spec
        would see the stale creation value ("false") and let a restarted
        agent's startup cleanup delete a slice that is running a workload."""
        node = self._node_of(qr)
        labels = node.get("labels", {})
        if labels.get(LABEL_MANAGED) != "true":
            return None  # foreign queued resource in the same project/zone
        try:
            profile = Profile.parse(labels[LABEL_PROFILE])
            origin = tuple(int(x) for x in labels[LABEL_ORIGIN].split("-"))
            dims = tuple(int(x) for x in labels[LABEL_DIMS].split("-"))
        except (KeyError, ValueError):
            logger.warning("cloud tpulib: malformed geometry labels on %s", qr.get("name"))
            return None
        name = qr.get("name", "")
        live = node_labels if node_labels is not None else labels
        return SliceHandle(
            slice_id=name.rsplit("/", 1)[-1],
            profile=profile,
            origin=origin,
            dims=dims,
            in_use=live.get(LABEL_IN_USE) == "true",
        )

    def _get_qr(self, slice_id: str) -> dict:
        return self._request("GET", self._qr_path(slice_id))

    def _list_qrs(self) -> List[dict]:
        out: List[dict] = []
        token: Optional[str] = None
        while True:
            params = {"pageSize": 100}
            if token:
                params["pageToken"] = token
            page = self._request("GET", self._qr_path(), params=params)
            out.extend(page.get("queuedResources", []))
            token = page.get("nextPageToken")
            if not token:
                return out

    def _list_node_labels(self) -> Dict[str, dict]:
        """node id -> live labels, via LIST nodes (one paginated call, not a
        GET per slice)."""
        out: Dict[str, dict] = {}
        token: Optional[str] = None
        while True:
            params = {"pageSize": 100}
            if token:
                params["pageToken"] = token
            page = self._request(
                "GET", f"/v2/{self._parent}/nodes", params=params
            )
            for node in page.get("nodes", []):
                node_id = node.get("name", "").rsplit("/", 1)[-1]
                out[node_id] = node.get("labels", {})
            token = page.get("nextPageToken")
            if not token:
                return out

    def _node_labels(self, slice_id: str) -> Optional[dict]:
        try:
            node = self._request("GET", self._node_path(slice_id))
        except CloudApiError as exc:
            if exc.code == 404:
                return None  # not provisioned (yet/anymore)
            raise
        return node.get("labels", {})

    # -- TpuClient ------------------------------------------------------------
    def get_topology(self) -> Topology:
        return self._topology

    def list_slices(self) -> List[SliceHandle]:
        node_labels = self._list_node_labels()
        handles = []
        for qr in self._list_qrs():
            state = qr.get("state", {}).get("state")
            if state not in _LIVE_STATES:
                continue
            slice_id = qr.get("name", "").rsplit("/", 1)[-1]
            handle = self._handle_of(qr, node_labels.get(slice_id))
            if handle is not None:
                handles.append(handle)
        return sorted(handles, key=lambda s: s.slice_id)

    def create_slice(
        self, profile: Profile, origin: Tuple[int, ...], dims: Tuple[int, ...]
    ) -> SliceHandle:
        with self._lock:
            # Monotonic suffix for uniqueness within one client; a collision
            # with a pre-restart resource surfaces as 409 ALREADY_EXISTS and
            # the caller's startup cleanup (delete_all_except) clears it —
            # profile names are [0-9x]+, already RFC-1035 safe.
            self._counter += 1
            slice_id = (
                f"nos-{profile.name}-"
                f"{'-'.join(str(o) for o in origin)}-{self._counter}"
            )
        body = {
            "tpu": {
                "nodeSpec": [
                    {
                        "parent": self._parent,
                        "nodeId": slice_id,
                        "node": {
                            "acceleratorType": self.accelerator_type_fn(profile),
                            "runtimeVersion": self.runtime_version,
                            "labels": {
                                LABEL_MANAGED: "true",
                                LABEL_PROFILE: profile.name,
                                LABEL_ORIGIN: "-".join(str(o) for o in origin),
                                LABEL_DIMS: "-".join(str(d) for d in dims),
                                LABEL_IN_USE: "false",
                            },
                        },
                    }
                ]
            }
        }
        op = self._request(
            "POST", self._qr_path(), params={"queuedResourceId": slice_id}, body=body
        )
        try:
            self._wait_operation(op, f"create_slice {slice_id}")
            qr = self._get_qr(slice_id)
            state = qr.get("state", {}).get("state")
            deadline = time.monotonic() + self.provision_timeout_s
            while state in _PENDING_STATES:
                # The create operation can complete at ACCEPTED; ACTIVE is the
                # queued-resource state machine's own transition.
                if time.monotonic() >= deadline:
                    raise ProvisioningTimeout(
                        f"create_slice {slice_id}: still {state} after "
                        f"{self.provision_timeout_s}s"
                    )
                self._sleep(self.poll_interval_s)
                qr = self._get_qr(slice_id)
                state = qr.get("state", {}).get("state")
            if state not in _LIVE_STATES:
                detail = qr.get("state", {}).get("stateInitiator", "")
                raise ProvisioningError(
                    f"create_slice {slice_id}: terminal state {state} {detail}".strip()
                )
        except (ProvisioningError, ProvisioningTimeout, QuotaExhaustedError):
            # Operational hygiene on the real surface: a FAILED queued
            # resource holds its name (and sometimes reserved capacity)
            # until deleted — GC it best-effort so the zone doesn't
            # accumulate corpses and the name space stays clean.
            try:
                self._request(
                    "DELETE", self._qr_path(slice_id), params={"force": "true"}
                )
            except TpuLibError:
                pass
            raise
        handle = self._handle_of(qr)
        if handle is None:
            raise TpuLibError(f"create_slice {slice_id}: geometry labels lost on wire")
        return handle

    def delete_slice(self, slice_id: str) -> None:
        qr = self._get_qr(slice_id)
        handle = self._handle_of(qr, self._node_labels(slice_id))
        if handle is not None and handle.in_use:
            raise TpuLibError(f"slice {slice_id} is in use")
        op = self._request(
            "DELETE", self._qr_path(slice_id), params={"force": "true"}
        )
        self._wait_operation(op, f"delete_slice {slice_id}")

    def delete_all_except(self, keep_ids: List[str]) -> List[str]:
        deleted = []
        for handle in self.list_slices():
            if handle.slice_id in keep_ids or handle.in_use:
                continue
            self.delete_slice(handle.slice_id)
            deleted.append(handle.slice_id)
        return deleted

    def set_slice_in_use(self, slice_id: str, in_use: bool) -> None:
        qr = self._get_qr(slice_id)
        if self._handle_of(qr) is None:
            raise TpuLibError(f"no such slice {slice_id}")
        op = self._request(
            "PATCH",
            self._node_path(slice_id),
            params={"updateMask": "labels"},
            body={"labels": {LABEL_IN_USE: "true" if in_use else "false"}},
        )
        self._wait_operation(op, f"set_slice_in_use {slice_id}")

    def health(self) -> Optional[str]:
        try:
            self._request("GET", self._qr_path(), params={"pageSize": 1})
            return None
        except TpuLibError as exc:
            return f"provisioning API unhealthy: {exc}"
