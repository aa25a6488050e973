"""Demo inference server on the PyTorch/CUDA port (`nos_tpu_torch`): the
port's SliceServer behind a minimal HTTP front, the counterpart of
`serve.py`.

POST /infer {"seed": int} -> {"labels": [...], "scores": [...],
"boxes": [...], "latency_s": float}. The client sends a seed, not pixels:
the server generates the deterministic image on the device, so the wire
stays off the measured path (the reference demo's clients likewise generate
their inputs in-process and measure inference only).

GET /metrics serves the runtime's Prometheus surface (request counts, the
last latency) for the PodMonitor, on the serving port and on its own
listener at METRICS_PORT.

    PORT=8090 METRICS_PORT=8081 python examples/sharing-comparison/serve_torch.py
    DEVICE=cpu python examples/sharing-comparison/serve_torch.py   # plain versions

The model runs on the CUDA card unless DEVICE=cpu (no CUDA device raises).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _metrics_body():
    from nos_tpu_torch.observability import metrics

    return metrics.render().encode()


class _MetricsHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        body = _metrics_body()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.end_headers()
        self.wfile.write(body)


def make_server(port: int, cfg=None, device=None, max_batch: int = 8,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The HTTP front on `port` (0: any free port; `.server_address` says
    which) over a started SliceServer of `vit_detect` (`cfg` None: the
    YOLOS-small default, seed-0 weights) on `device` (None: CUDA), every
    bucket warmed. Serve with `serve_forever()`; stop with `shutdown()`,
    then `.slice_server.stop()`."""
    import torch

    from nos_tpu_torch.device import resolve
    from nos_tpu_torch.models.vit import ViTConfig, init_vit, vit_detect
    from nos_tpu_torch.observability import metrics
    from nos_tpu_torch.runtime.slice_server import SliceServer
    from run_local_torch import make_image

    device = resolve(device, "serve_torch.py")
    cfg = cfg or ViTConfig()
    params = init_vit(cfg, torch.Generator().manual_seed(0), device=device)
    server = SliceServer(lambda im: vit_detect(params, im, cfg), max_batch=max_batch,
                         max_wait_s=0.003)
    server.warmup(make_image(cfg, 0, device))
    server.start()
    images: dict = {}
    images_lock = threading.Lock()

    class Handler(_MetricsHandler):
        def do_GET(self):
            if self.path == "/metrics":
                return super().do_GET()
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok\n")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            seed = int(json.loads(self.rfile.read(length) or b"{}").get("seed", 0))
            with images_lock:
                image = images.get(seed)
                if image is None:
                    image = images[seed] = make_image(cfg, seed, device)
            t0 = time.perf_counter()
            labels, scores, boxes = server.infer(image, timeout=120)
            latency = time.perf_counter() - t0
            metrics.inc("sharing_demo_requests")  # renders *_total
            metrics.set_gauge("sharing_demo_last_latency_seconds", latency)
            body = json.dumps({
                "labels": labels.tolist(),
                "scores": scores.tolist(),
                "boxes": boxes.tolist(),
                "latency_s": latency,
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.slice_server = server
    return httpd


def main() -> int:
    port = int(os.environ.get("PORT", "8090"))
    metrics_port = int(os.environ.get("METRICS_PORT", "8081"))
    httpd = make_server(port, device=os.environ.get("DEVICE") or None,
                        max_batch=int(os.environ.get("MAX_BATCH", "8")))
    # A metrics listener of its own on the port the PodMonitor scrapes (the
    # control-plane binaries' split: serving and observability never share
    # a port).
    metrics_httpd = ThreadingHTTPServer(("0.0.0.0", metrics_port), _MetricsHandler)
    threading.Thread(target=metrics_httpd.serve_forever, daemon=True).start()
    print(f"sharing-server on :{port}, metrics on :{metrics_port} "
          f"(max_batch {httpd.slice_server.max_batch})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.slice_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
