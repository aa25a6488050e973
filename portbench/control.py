"""Readings behind a cell's correctness limit: the program's and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... --seconds 6

For each seed the cell runs as the benchmark runs it (weights, engine,
warm requests, its traffic for `--seconds`, every request sent followed to
completion), and the same sample of served requests that `check.py` takes
is compared with the float32 reference twice: the program's widest gap
(`max_logit_gap`, the number a run compares with its limit) and the
control's (`control_max_logit_gap`): the reference computed one precision
below the configuration's, at each position the gap of the token that the
lower precision puts first. bf16 and fp16 configurations take fp8 (e4m3,
a scale per row of activations, per output column of weights, per token
of K and V); float32 takes bf16 rounding. One JSON line a seed, then one
with the largest program reading and the smallest control reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def fp8(x, dim):
    """Round x through float8 e4m3 with one scale per slice along `dim`."""
    import torch

    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def bf16(x, dim):
    import torch

    return x.to(torch.bfloat16).float()


def lower_precision(shape):
    return bf16 if shape.dtype == "float32" else fp8


def readings(cell: str, seeds, seconds: float, device: str = "cuda", roots=()):
    """Yield one dict of readings a seed."""
    from portbench import check, harness

    for seed in seeds:
        t = time.monotonic()
        run = harness.Run(cell, seed, seconds, False, t, device=device, roots=roots)
        driver = harness.load_module("drivers", run.cell.get("driver", "serve"), run.roots)
        driver.run(run)
        chk = run.cell["check"]
        picked = check.sample(run.served.records, seed, int(chk["requests"]))
        got = check.compare(run.reference.logits_at, run.params, run.config, picked,
                            quant=lower_precision(run.shape))
        unfinished = sum(1 for r in run.served.records if r.error or r.done is None)
        yield {"cell": cell, "seed": seed, **got, "unfinished": unfinished,
               "limit": float(chk["max_logit_gap"]), "seconds": time.monotonic() - t}
        run.params = None


def main(argv=None) -> int:
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for row in readings(args.workload, seeds, args.seconds):
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "cell": args.workload, "seeds": len(rows),
        "program_max": max(r["max_logit_gap"] for r in rows),
        "control_min": min(r["control_max_logit_gap"] for r in rows),
        "control_max": max(r["control_max_logit_gap"] for r in rows),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
