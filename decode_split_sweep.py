#!/usr/bin/env python3
"""Time the split decode kernels (nos_tpu_torch/ops/csrc/split_decode.cuh)
at each split length on one NVIDIA GPU, the evidence for kSplitKeys.

    python3 decode_split_sweep.py                 # kSplitKeys 128 and 256
    python3 decode_split_sweep.py --splits 64,128,256
    python3 decode_split_sweep.py --as-built      # time the package's own build only

For each split length the script copies csrc/ into the kernels' build
directory (gitignored) with kSplitKeys set to it, builds the paged and
dense kernels from that copy (printing ptxas' registers and spills of the
split kernels), holds them against their plain versions at split-boundary
limits (chip_smoke.py's TOL / RTOL for the paged kernel, DECODE_TOL for the
dense one, two launches equal bit for bit), and times them at chip_smoke's
shapes (decode_main, decode_ctx8192, dense_main and dense_ctx8192) with
chip_smoke.py's `time_cuda` (ms, the wrapper's host work included) and
`device_ms` (the kernel's own time, from torch.profiler). The lengths are timed in
turns (a, b, ..., b, a) and each time is the mean of its turns. Prints one
JSON line per length and, last, {"splits": {...}} with every time. The
package's own build always uses the constant in the checked-in header.
`--as-built` times the decode kernels of the package as it stands (twice,
no copies, no checks), so that another checkout's kernels, an earlier
commit's with this script and chip_smoke.py beside them, time the same way
in the same call.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys

import numpy as np

import chip_smoke as cs


def use_split(torch, keys):
    """Point `_build` at a copy of csrc/ with kSplitKeys = keys."""
    from nos_tpu_torch.ops import _build

    src = _build.BUILD_DIR.parent / "csrc"
    dst = _build.BUILD_DIR / f"csrc-split{keys}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    header = dst / "split_decode.cuh"
    text, n = re.subn(r"constexpr int kSplitKeys = \d+;", f"constexpr int kSplitKeys = {keys};",
                      header.read_text())
    cs.check(n == 1, "kSplitKeys not found in split_decode.cuh")
    header.write_text(text)
    _build.CSRC = dst
    _build._libs.clear()
    _build._counters.clear()
    _build.split_keys.cache_clear()
    cs.check(_build.split_keys() == keys, "the copy's kSplitKeys did not take")
    torch.cuda.synchronize()


def build(keys):
    from concurrent.futures import ThreadPoolExecutor

    from nos_tpu_torch.ops import _build

    names = ("paged_attention", "decode_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(_build.build, names)))
    for name, text in logs.items():
        for entry in cs.ptxas_entries(text):
            if "split_decode_kernel" in entry["function"]:
                cs.log(f"split{keys} ptxas[{name}]: {json.dumps(entry)}")


def check(torch, keys):
    """Both kernels against their plain versions at split-boundary limits,
    every dtype and several head layouts; two launches equal bit for bit;
    paged limit 0 gives zeros."""
    from nos_tpu_torch.ops import decode_attention as da
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.ops.flash_attention import flash_err

    gen = torch.Generator(device="cuda").manual_seed(keys)
    edges = [1, keys - 1, keys, keys + 1, 2 * keys - 1, 2 * keys, 2 * keys + 1]
    worst = {"paged": 0.0, "dense": 0.0}
    # (nh, nkv, hd, bs): the serving heads; rep 1 at 128; rep 8 at 256; rep
    # 12 (two row tiles) at 32 over 64-key pages; hd 40 over 24-key pages.
    for nh, nkv, hd, bs in ((8, 2, 64, 32), (4, 4, 128, 16), (8, 1, 256, 8), (12, 1, 32, 64),
                            (6, 3, 40, 24)):
        n_pages = -(-(4 * keys + 40) // bs)
        b = len(edges) + 1
        total = 1 + b * n_pages
        for dtype in ("float32", "bfloat16", "int8"):
            k, v, ks, vs, qdt = cs._pools(torch, gen, dtype, total, nkv, bs, hd)
            table = cs._table(torch, gen, b, n_pages, total)
            q = torch.randn((b, nh, hd), generator=gen, device="cuda").to(qdt)
            for limits in (edges + [n_pages * bs + 7], [n_pages * bs - 1] + edges[::-1]):
                lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
                got = pa.paged_decode_attention(q, k, v, table, lim, ks, vs)
                again = pa.paged_decode_attention(q, k, v, table, lim, ks, vs)
                want = pa._reference(q, k, v, table, lim, ks, vs)
                cs.held(torch, got, want, dtype, f"paged_decode_attention nh={nh} nkv={nkv} "
                        f"hd={hd} bs={bs} limits={limits}",
                        {"paged_decode_attention": 0.0, "paged_decode_attention_rel": 0.0})
                cs.check(torch.equal(got, again), f"paged split{keys}: two launches differ")
                err = (got.float() - want.float()).abs().max().item()
                worst["paged"] = max(worst["paged"], err)
            zero = pa.paged_decode_attention(q, k, v, table, torch.zeros_like(lim), ks, vs)
            torch.cuda.synchronize()
            cs.check(bool((zero == 0).all()), f"paged split{keys}: limit 0 is not zeros")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            max_len = 4 * keys + 40
            limits = [0, -3, max_len, max_len + 9] + edges
            b = len(limits)
            q = torch.randn((b, nh, hd), generator=gen, device="cuda").to(dt)
            kc, vc = (torch.randn((b, nkv, max_len, hd), generator=gen, device="cuda").to(dt)
                      for _ in range(2))
            lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
            got = da.decode_attention(q, kc, vc, lim)
            again = da.decode_attention(q, kc, vc, lim)
            want = da._reference(q, kc, vc, lim)
            torch.cuda.synchronize()
            ratio = flash_err(got, want)
            cs.check(ratio <= cs.DECODE_TOL[dtype] and torch.equal(got, again),
                     f"decode_attention split{keys} {dtype} nh={nh} nkv={nkv} hd={hd} "
                     f"limits={limits}: flash_err {ratio}, equal {torch.equal(got, again)}")
            worst["dense"] = max(worst["dense"], ratio)
    cs.log(f"split{keys} check: every case within bounds, two launches equal "
           f"(worst {json.dumps(worst)})")


CASES = ("decode_main", "decode_ctx8192", "dense_main", "dense_ctx8192")


def times(torch):
    """time_cuda's ms and the profiler's device ms of each case."""
    from nos_tpu_torch.ops import paged_attention as pa

    out = cs.time_kernels(torch, pa, decode_only=True)
    out.update(cs.time_decode(torch))
    return {f"{case}_{what}": out[case][what] for case in CASES for what in ("ms", "device_ms")}


def mean_of(runs):
    """Each time's mean over the runs (None where a device time was not
    measured in any)."""
    out = {}
    for name in runs[0]:
        got = [r[name] for r in runs if r[name] is not None]
        out[name] = float(np.mean(got)) if got else None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", default="128,256")
    ap.add_argument("--as-built", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_card(torch)
    if args.as_built:
        print(json.dumps({"as_built": mean_of([times(torch) for _ in range(2)])}), flush=True)
        return 0
    splits = [int(x) for x in args.splits.split(",")]
    for keys in splits:
        use_split(torch, keys)
        build(keys)
        check(torch, keys)
    runs = {k: [] for k in splits}
    for keys in splits + splits[::-1]:
        use_split(torch, keys)
        runs[keys].append(times(torch))
        cs.log(f"split{keys} times: {json.dumps(runs[keys][-1])}")
    result = {str(k): mean_of(rs) for k, rs in runs.items()}
    print(json.dumps({"splits": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
