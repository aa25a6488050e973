"""Port of `nos_tpu/cluster/webhook_server.py` (:1-149):
`AdmissionWebhookServer` (:31). Copied verbatim; only the imports point at
the port, which imports nothing of the JAX package.

AdmissionReview v1 webhook server.

Serves the validating webhooks registered on a cluster backend (the registry a
``KubeCluster.register_webhook`` call populates) over HTTP, the way the
reference operator's manager serves SetupWebhookWithManager handlers
(elasticquota_webhook.go:48-87, compositeelasticquota_webhook.go) behind a
ValidatingWebhookConfiguration. The API server (real, or the emulator via
``add_remote_webhook``) POSTs an AdmissionReview; a hook raising
AdmissionError turns into ``response.allowed=false`` with the message.

Endpoints: ``/validate`` (any kind) and ``/validate/<kind>`` both work — the
review's object kind selects the hooks.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from nos_tpu_torch.cluster.client import AdmissionError
from nos_tpu_torch.cluster.serialize import from_wire

logger = logging.getLogger(__name__)

HookRegistry = Dict[str, List[Callable[[str, Any, Optional[Any]], None]]]


class AdmissionWebhookServer:
    def __init__(
        self,
        registry: HookRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
    ):
        """In-cluster: host='0.0.0.0', port=9443, and certfile/keyfile from
        the secret cert-manager writes and the chart mounts (a real API server
        requires HTTPS webhooks; the caBundle comes from
        cert-manager.io/inject-ca-from). Loopback HTTP is the emulator/test
        path."""
        self.registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Bound per-connection reads: a stalled peer must never wedge a
            # handler thread forever.
            timeout = 30

            def log_message(self, fmt, *args):  # noqa: N802
                logger.debug("webhook: " + fmt, *args)

            def do_POST(self):  # noqa: N802
                server._handle(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._tls = bool(certfile and keyfile)
        if self._tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=certfile, keyfile=keyfile)
            # Defer the handshake to the per-connection handler thread: with
            # do_handshake_on_connect=True it would run inside accept() on
            # the single serve_forever loop, letting one half-open client
            # (slow-loris, stalled LB probe) block every admission review.
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True, do_handshake_on_connect=False
            )
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}/validate"

    def start(self) -> "AdmissionWebhookServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="webhook-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def review(self, review: Dict[str, Any]) -> Dict[str, Any]:
        """Evaluate one AdmissionReview request dict; returns the full
        AdmissionReview response dict."""
        request = review.get("request") or {}
        uid = request.get("uid", "")
        try:
            obj_wire = request.get("object") or {}
            obj = from_wire(obj_wire)
            old_wire = request.get("oldObject")
            old = from_wire(old_wire) if old_wire else None
            op = request.get("operation", "CREATE")
            kind = obj_wire.get("kind", "")
            for hook in self.registry.get(kind, []):
                hook(op, obj, old)
            response: Dict[str, Any] = {"uid": uid, "allowed": True}
        except AdmissionError as e:
            response = {
                "uid": uid,
                "allowed": False,
                "status": {"code": 403, "message": str(e)},
            }
        except Exception as e:  # noqa: BLE001
            logger.exception("webhook review failed")
            response = {
                "uid": uid,
                "allowed": False,
                "status": {"code": 500, "message": f"webhook error: {e}"},
            }
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": response,
        }

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        try:
            length = int(req.headers.get("Content-Length") or 0)
            body = json.loads(req.rfile.read(length) or b"{}")
            out = json.dumps(self.review(body)).encode()
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(out)))
            req.end_headers()
            req.wfile.write(out)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("webhook request failed")
            try:
                req.send_response(500)
                req.send_header("Content-Length", "0")
                req.end_headers()
            except Exception:  # noqa: BLE001
                logger.debug("could not send 500 reply", exc_info=True)
