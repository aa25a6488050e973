"""Demo closed-loop client for the port's sharing server (`serve_torch.py`):
the counterpart of `client.py`, the reference demo's polling pod.

Hammers the sharing server with back-to-back /infer requests and reports
the observed per-request latency: the mean and p95 over a sliding window
printed every `--report` requests, and on GET /metrics (the port's
`observability.metrics`) for the PodMonitor. `--count N` stops after N
requests (0 runs forever). It touches no device.

    python examples/sharing-comparison/client_torch.py --server http://localhost:8090
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="http://localhost:8090")
    ap.add_argument("--seed", type=int, default=os.getpid())
    ap.add_argument("--report", type=int, default=20)
    ap.add_argument("--count", type=int, default=0, help="0 = run forever")
    ap.add_argument("--metrics-port", type=int, default=8081)
    args = ap.parse_args(argv)

    from nos_tpu_torch.observability import metrics

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("0.0.0.0", args.metrics_port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    window: list = []
    n = 0
    payload = json.dumps({"seed": args.seed}).encode()
    try:
        while args.count == 0 or n < args.count:
            t0 = time.perf_counter()
            req = urllib.request.Request(
                args.server + "/infer", data=payload,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                resp.read()
            latency = time.perf_counter() - t0
            n += 1
            window.append(latency)
            metrics.inc("sharing_demo_client_requests")  # renders *_total
            metrics.set_gauge("sharing_demo_client_latency_seconds", latency)
            if len(window) >= args.report:
                print(
                    f"requests {n}: mean {statistics.mean(window):.4f}s "
                    f"p95 {sorted(window)[int(0.95 * (len(window) - 1))]:.4f}s",
                    flush=True,
                )
                window.clear()
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
