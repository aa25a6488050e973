"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, when no CUDA device is present or
fewer than the cell's `chips`, and when the process holds JAX, jaxlib,
flax or the JAX package `nos_tpu` once the window has closed. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each number compared with its limit, also
printed as the last lines of standard error. The kernels' libraries and
any other build cache live at fixed paths inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def prepare_process() -> None:
    """Build caches at fixed paths inside the checkout, libraries kept from
    loading JAX on their own, and the checkout importable."""
    cache = CHECKOUT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    prepare_process()
    args = parse(argv)
    from portbench import harness

    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    import torch

    chips = int(run.cell.get("chips", 1))
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} CUDA devices, {torch.cuda.device_count()} present")
    result = execute(run, harness.benchmark_metrics(run.name, run.trace))
    if "forbidden" in result:
        return fail(f"the process holds {', '.join(result['forbidden'])} after the window", 3)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(run, names) -> dict:
    """Drive the cell, then check the process and build the result line
    (`{"forbidden": [...]}` alone if it holds a forbidden module)."""
    from portbench import harness

    driver = harness.load_module("drivers", run.cell.get("driver", "serve"), run.roots)
    driver.run(run)
    bad = harness.forbidden_modules()
    if bad:
        return {"forbidden": bad}
    return finish(run, names)


def finish(run, names) -> dict:
    """Compare the served tokens with the reference, read the metrics and
    build the result line."""
    import torch

    from portbench import check

    records = run.served.records
    unfinished = sum(1 for r in records if r.error is not None or r.done is None)
    chk = run.cell["check"]
    picked = check.sample(records, run.seed, int(chk["requests"]))
    got = (check.compare(run.reference.logits_at, run.params, run.config, picked)
           if picked else {})
    gap = got.get("max_logit_gap", float("inf"))
    checks = {
        "max_logit_gap": {"value": gap, "limit": float(chk["max_logit_gap"])},
        "unfinished_requests": {"value": unfinished, "limit": 0},
    }
    correct = bool(picked) and gap <= float(chk["max_logit_gap"]) and unfinished == 0
    metrics = run.read("metrics" if run.trace else "endtoend", names)
    on_gpu = str(run.device).startswith("cuda")
    device = {"platform": "gpu" if on_gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
              "count": int(run.cell.get("chips", 1)),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": len(records), "failed": unfinished,
              "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        t = run.trace_data
        device["busy_s"] = t.busy_s
        device["window_s"] = t.span_s
        result["breakdown"] = t.breakdown()
    late = run.served.lateness_s
    print(json.dumps({
        "cell": run.name, "seed": run.seed, "setup_s": run.setup_s,
        "setup_parts": run.setup_parts,
        "warm_requests": run.warm_requests, "window_end_s": run.served.end_s,
        "sent_late_max_s": max(late) if late else 0.0,
        "compared": {k: got.get(k) for k in ("tokens_compared", "requests_compared")},
        "work": vars(run.work),
        "trace_reduce_s": getattr(run.trace_data, "reduce_s", None),
        "trace_reduce_parts": getattr(run.trace_data, "reduce_parts", None),
        "kernels_traced": getattr(run.trace_data, "kernel_count", None),
        "counters": {k: v for k, v in run.counters[1].items() if k != "queue_wait_s"},
    }), file=sys.stderr)
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
