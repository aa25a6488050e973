"""Accelerator-sharing comparison on the PyTorch/CUDA port (`nos_tpu_torch`):
the port's counterpart of `run_local.py`, on one CUDA card.

The reference's demo (demos/gpu-sharing-comparison: 1/3/5/7 pods sharing
one A100 under time-slicing / MPS / MIG, average inference time of
YOLOS-small per pod count) is reproduced against ONE card shared through
the port's runtime:

  - mode `shared`: N closed-loop clients submit to one SliceServer, which
    micro-batches concurrent requests into single executions.
  - mode `sequential` (the time-slicing analog): the same N clients
    serialize through a lock, one inference at a time, minus the context
    switches of real time-slicing (so it flatters the baseline).

Usage:
    python examples/sharing-comparison/run_local_torch.py                # 1,3,5,7 shared
    python examples/sharing-comparison/run_local_torch.py --workloads 7
    python examples/sharing-comparison/run_local_torch.py --mode sequential
    python examples/sharing-comparison/run_local_torch.py --tiny --device cpu

The first line is the card's name and power limit (nvidia-smi). Then one
table row per workload count: the mean per-request latency over all
clients, beside upstream nos's published A100 numbers for the same
concurrency (BASELINE.md), for side-by-side reading. At the default 224 px
YOLOS-small has 296 tokens, under the ViT's flash threshold (1024), so
this demo runs no hand-written kernel, as the reference's runs no Pallas
kernel.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

# Upstream nos's published table on an NVIDIA A100 (demos/gpu-sharing-
# comparison/README.md:60-72, BASELINE.md): average inference time (s) per
# pod count. Not measured here.
REFERENCE = {
    "time-slicing": {1: 0.0882, 3: 0.2931, 5: 0.4890, 7: 0.6849},
    "mps": {1: 0.0880, 3: 0.1640, 5: 0.2409, 7: 0.3198},
    "mig": {1: 0.3424, 3: 0.3413, 5: 0.3453, 7: 0.3442},
}

WARMUP_REQUESTS = 3
MEASURE_REQUESTS = 20


def card_line(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for a CUDA device (its first
    line), or the device itself off CUDA."""
    if device.type != "cuda":
        return f"card: none ({device})"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return f"card: {out[0] if out else 'nvidia-smi gave no output'}"


def make_image(cfg, seed: int, device):
    """Client `seed`'s image, uniform [0, 1), generated on `device`."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((cfg.image_size, cfg.image_size, 3), generator=gen, device=device)


def build_server(cfg, params, max_batch: int, device):
    from nos_tpu_torch.models.vit import vit_detect
    from nos_tpu_torch.runtime.slice_server import SliceServer

    buckets = sorted({b for b in (1, 2, 4, max_batch) if b <= max_batch})
    server = SliceServer(
        lambda im: vit_detect(params, im, cfg),
        max_batch=max_batch,
        max_wait_s=0.003,
        buckets=buckets,
    )
    server.warmup(make_image(cfg, 0, device))
    return server.start()


def run_point(cfg, params, n: int, mode: str, device) -> dict:
    """n closed-loop clients, `WARMUP_REQUESTS` unmeasured and
    `MEASURE_REQUESTS` measured requests each. -> {"mean_s": mean
    per-request latency (s), "images": client i's image, "results":
    client i's measured outputs (labels, scores, boxes on the host),
    "batches_run", "requests_served", "requests_per_batch"}."""
    server = build_server(cfg, params, max_batch=n if mode == "shared" else 1, device=device)
    serial = threading.Lock() if mode == "sequential" else None
    images = [make_image(cfg, i, device) for i in range(n)]
    results: list = [[] for _ in range(n)]
    latencies: list = []
    errors: list = []
    lock = threading.Lock()

    def infer(image):
        if serial:
            with serial:
                return server.infer(image, timeout=120)
        return server.infer(image, timeout=120)

    def client(i: int) -> None:
        try:
            mine = []
            for _ in range(WARMUP_REQUESTS):
                infer(images[i])
            for _ in range(MEASURE_REQUESTS):
                t0 = time.perf_counter()
                results[i].append(infer(images[i]))
                mine.append(time.perf_counter() - t0)
            with lock:
                latencies.extend(mine)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    if errors:
        raise errors[0]
    return {
        "mean_s": statistics.mean(latencies),
        "images": images,
        "results": results,
        "batches_run": server.batches_run,
        "requests_served": server.requests_served,
        "requests_per_batch": server.requests_served / max(server.batches_run, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", type=int, nargs="*", default=[1, 3, 5, 7])
    ap.add_argument("--mode", choices=("shared", "sequential"), default="shared")
    ap.add_argument(
        "--tiny", action="store_true",
        help="toy model for smoke runs (seconds on the CPU; numbers are "
        "meaningless: the real sweep uses the YOLOS-small default)",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    import torch

    from nos_tpu_torch.device import resolve
    from nos_tpu_torch.models.vit import ViTConfig, init_vit

    device = resolve(args.device, "run_local_torch.py")
    print(card_line(device), flush=True)
    if args.tiny:
        cfg = ViTConfig(image_size=32, patch_size=16, hidden=64, layers=1,
                        heads=2, det_tokens=5)
    else:
        cfg = ViTConfig()  # YOLOS-small class
    params = init_vit(cfg, torch.Generator().manual_seed(0), device=device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"device: {kind} | mode: {args.mode}")
    print(f"{'N':>3}  {'this port':>15}  {'A100 MPS':>9}  {'A100 MIG':>9}  "
          f"{'A100 t-slice':>12}   (A100 columns: upstream nos's published table)")
    for n in args.workloads:
        mean_s = run_point(cfg, params, n, args.mode, device)["mean_s"]
        ref = {k: v.get(n) for k, v in REFERENCE.items()}
        fmt = lambda v: f"{v:.4f}s" if v else "-"  # noqa: E731
        print(
            f"{n:>3}  {mean_s:>14.4f}s  {fmt(ref['mps']):>9}  "
            f"{fmt(ref['mig']):>9}  {fmt(ref['time-slicing']):>12}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
