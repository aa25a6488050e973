#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases build,card,kernels
    python3 chip_smoke.py --rehearse      # tiny model on the CPU, plain versions

Phases, in order (any failure exits non-zero; nothing is caught and passed over):

  build    builds every kernel of `nos_tpu_torch/ops/csrc/` with nvcc (one
           process per source, started together) and prints ptxas' report;
  card     prints `nvidia-smi --query-gpu=name,power.limit`;
  kernels  holds each kernel against its plain PyTorch version on the card at
           the serving shapes (B=8, nh=8, nkv=2, hd=64, bs=32): contexts 1, 31,
           32, 33, 2048 and 8192, windows of 16 and 256 with ragged lengths,
           masked lanes and shared pages, pools in f32, bf16 and int8 with
           scales (max|err| <= 1e-4 for f32, 5e-3 for bf16 and 2e-2 for int8,
           and <= 2e-2 of max|want| for bf16 and int8), and times the kernel,
           its plain version and scaled_dot_product_attention on the
           pre-gathered cache;
  engine   serves the bench GPT (vocab 32000, hidden 512, 8 layers, 8 heads, 2
           KV heads) with random weights from init_gpt(seed 0) in bf16, 8 slots,
           max_len 8192, a prefill budget of two 256-token chunks per tick: six
           streams (prompts of 64-256 tokens, 128 new) and two 4096-token
           prompts arriving together while they decode, whose chunks batch
           through the multi-slot prefill window. The launch counts are zeroed
           just before that run and read just after; then every output is
           checked against a teacher-forced greedy pass of the plain programs
           on the card (see check_engine for the bounds), and the run repeats
           in float32, where the strict agreement must be 1.0. A profiler
           window over 16 decode steps reports host and device time per step.

The line before the last is the `kernels` JSON object; the last line is
{"ok": true, "device": {...}}, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16
# Kernel against plain version: max|err|, and max|err| / max|want|. The
# bf16 bound is pinned at 2.5x the worst error measured on these inputs
# (2.0e-3, window kernel); int8 and f32 keep the bounds first set for them.
TOL = {"float32": 1e-4, "bfloat16": 5e-3, "int8": 2e-2}
RTOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}
# The bf16 engine's teacher-forced oracle: the kernel arm's logits against
# the plain arm's (see check_engine), pinned at about 2.3x what this
# traffic measured on an NVIDIA H100 80GB HBM3 at 700 W (max 0.064, mean
# 0.0085). Re-pin only with a new measurement recorded in PERF.md.
MAX_DLOGIT_BF16 = 0.15
MEAN_DLOGIT_BF16 = 0.02
# Decode lanes mid-run: six streams, then the two long prompts.
MAIN_DECODE_LIMITS = [128, 160, 192, 224, 288, 320, 4160, 4160]


def log(*args):
    print(*args, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# -- timing ------------------------------------------------------------------
def time_cuda(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of `fn` per call, each call timed with CUDA events
    after a 128 MiB write that evicts the 50 MB L2 (the engine reaches the
    pool with a cold cache: eight layers of weights pass between reads)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


# -- phase: build ------------------------------------------------------------
def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from nos_tpu_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        logs = dict(zip(names, pool.map(_build.build, names)))
    log(f"build: {names} wall_s={time.perf_counter() - t0:.2f}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas[{name}]: {line.strip()}")


# -- phase: card ---------------------------------------------------------------
def phase_card(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0] if out else "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


# -- phase: kernels --------------------------------------------------------------
def _pools(torch, gen, dtype, total, nkv, bs, hd):
    dev = "cuda"
    if dtype == "int8":
        k = torch.randint(-127, 128, (total, nkv, bs, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (total, nkv, bs, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((total,), generator=gen, device=dev) * 0.02 + 0.001
        vs = torch.rand((total,), generator=gen, device=dev) * 0.02 + 0.001
        return k, v, ks, vs, torch.bfloat16
    dt = getattr(torch, dtype)
    k = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(dt)
    return k, v, None, None, dt


def _table(torch, gen, b, n_pages, total):
    """Each row owns n_pages distinct pages; rows 0 and 1 share their first
    eight pages (a shared prefix)."""
    perm = torch.randperm(total - 1, generator=gen, device="cuda")[: b * n_pages] + 1
    table = perm.reshape(b, n_pages).to(torch.int32)
    table[1, :8] = table[0, :8]
    return table.contiguous()


def decode_bytes(limits, nh, nkv, hd, bs, kv_itemsize, q_itemsize):
    """Bytes the decode kernel must move: the K and V pages under each
    limit, q and out once, the table entries it reads and the limits."""
    pages = sum(-(-int(x) // bs) for x in limits)
    pool = pages * nkv * bs * hd * 2 * kv_itemsize
    qo = 2 * len(limits) * nh * hd * q_itemsize
    return pool + qo + 4 * (pages + len(limits))


def held(torch, got, want, dtype, what, worst):
    """Hold a kernel's output against its plain version's; record the
    worst max|err| and relative error (over max|want|) per kernel."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    check(np.isfinite(err) and err <= TOL[dtype] and rel <= RTOL[dtype],
          f"{what} {dtype}: max|err| {err} (bound {TOL[dtype]}), "
          f"relative {rel} (bound {RTOL[dtype]})")
    name = what.split(" ")[0]
    worst[name] = max(worst[name], err)
    worst[name + "_rel"] = max(worst[name + "_rel"], rel)


def phase_kernels(torch):
    from nos_tpu_torch.ops import paged_attention as pa

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("paged_decode_attention", "paged_window_attention")
    worst = {n + sfx: 0.0 for n in names for sfx in ("", "_rel")}
    for dtype in ("float32", "bfloat16", "int8"):
        k, v, ks, vs, qdt = _pools(torch, gen, dtype, T, NKV, BS, HD)
        table = _table(torch, gen, B, P, T)
        q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(qdt)
        # Decode: every row at one context (pages past it -> scratch 0), then
        # a ragged mix of all of them.
        cases = [[c] * B for c in (1, 31, 32, 33, 2048, 8192)]
        cases.append([1, 31, 32, 33, 2048, 8192, 100, 4160])
        for limits in cases:
            tab = table.clone()
            tab[:, -(-max(limits) // BS):] = 0
            lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
            got = pa.paged_decode_attention(q, k, v, tab, lim, ks, vs)
            want = pa._reference(q, k, v, tab, lim, ks, vs)
            held(torch, got, want, dtype, f"paged_decode_attention limits={limits}", worst)
        # Windows: ragged lengths, two masked lanes, shared pages.
        for w in (16, 256):
            qw = torch.randn((B, NH, w, HD), generator=gen, device="cuda").to(qdt)
            pos = torch.tensor([0, 31, 33, 1000, 2047, 4096, 7000, 8192 - w],
                               dtype=torch.int32, device="cuda")
            lengths = torch.tensor([w, 1, w - 3, w, 5, w, w // 2, w],
                                   dtype=torch.int32, device="cuda")
            mask = torch.tensor([True, True, True, False, True, True, False, True],
                                device="cuda")
            got = pa.paged_window_attention(qw, k, v, table, pos, lengths, mask, ks, vs)
            want = pa._window_reference(qw, k, v, table, pos, lengths, mask, ks, vs)
            held(torch, got, want, dtype, f"paged_window_attention W={w}", worst)
        log(f"kernels {dtype}: decode and window within {TOL[dtype]} "
            f"(relative {RTOL[dtype]}; worst so far {json.dumps(worst)})")
        del k, v, ks, vs
    timings = time_kernels(torch, pa)
    return worst, timings


def _sdpa_decode(torch, q, k_dense, v_dense, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k_dense, v_dense, attn_mask=mask)


def time_kernels(torch, pa):
    """Kernel, plain version and SDPA (on a pre-gathered dense cache) at the
    main path's shapes, bf16 pool: the decode step's B=8 lanes at the mixed
    contexts of the served traffic, and 256-token prefill chunks at
    position 2048, alone and as a two-lane wave among eight. Also a context
    sweep for the decode kernel."""
    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(1)
    k, v, _, _, dt = _pools(torch, gen, "bfloat16", T, NKV, BS, HD)
    table = _table(torch, gen, B, P, T)
    table[1, :8] = torch.arange(9, 17, device="cuda", dtype=torch.int32)  # no sharing
    out = {}

    def decode_case(limits):
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(dt)
        n_pages = -(-max(limits) // BS)
        tab = table[:, :n_pages].contiguous()
        kd = pa._gather_pool(k, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        vd = pa._gather_pool(v, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        idx = torch.arange(kd.shape[2], device="cuda")
        mask = (idx[None, :] < lim[:, None])[:, None, None, :]
        ms = time_cuda(torch, lambda: pa.paged_decode_attention(q, k, v, tab, lim))
        plain = time_cuda(torch, lambda: pa._reference(q, k, v, tab, lim))
        lib = time_cuda(torch, lambda: _sdpa_decode(torch, q[:, :, None, :], kd, vd, mask))
        nbytes = decode_bytes(limits, NH, NKV, HD, BS, 2, 2)
        flops = 4.0 * NH * HD * sum(limits)
        bound = 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS)
        return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_BF16_FLOPS
                else "operations", "bytes": nbytes}

    out["decode_main"] = decode_case(MAIN_DECODE_LIMITS)
    for ctx in (512, 2048, 8192):
        out[f"decode_ctx{ctx}"] = decode_case([ctx] * B)

    def window_case(pos0, active):
        """One window launch over table rows 0..B-1: lanes in `active` hold
        a 256-token chunk at position pos0, the rest are masked (they read
        one position). B=1 is a prefill chunk, B=8 a multi-slot wave."""
        b = len(active)
        W = 256
        qw = torch.randn((b, NH, W, HD), generator=gen, device="cuda").to(dt)
        n_pages = -(-(pos0 + W) // BS)
        tab = table[:b, :n_pages].contiguous()
        pos = torch.full((b,), pos0, dtype=torch.int32, device="cuda")
        lengths = torch.full((b,), W, dtype=torch.int32, device="cuda")
        mask = torch.tensor(active, device="cuda")
        kd = pa._gather_pool(k, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        vd = pa._gather_pool(v, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        offs = torch.arange(W, device="cuda")
        lim = torch.where(mask[:, None], pos0 + offs[None, :] + 1, 1)  # [b, W]
        idx = torch.arange(kd.shape[2], device="cuda")
        causal = (idx[None, None, :] < lim[:, :, None])[:, None]  # [b, 1, W, S]
        ms = time_cuda(torch, lambda: pa.paged_window_attention(qw, k, v, tab, pos,
                                                                lengths, mask))
        plain = time_cuda(torch, lambda: pa._window_reference(qw, k, v, tab, pos,
                                                              lengths, mask))
        lib = time_cuda(torch, lambda: _sdpa_decode(torch, qw, kd, vd, causal))
        pages = sum(-(-int(x) // BS) for x in lim.max(dim=1).values.tolist())
        nbytes = (pages * NKV * BS * HD * 2 * 2 + 2 * b * NH * W * HD * 2
                  + 4 * pages + 9 * b)
        flops = 4.0 * NH * HD * float(lim.sum().item())
        return {"ms": ms, "plain_ms": plain, "library_ms": lib,
                "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS),
                "bound_by": "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_BF16_FLOPS
                else "operations", "bytes": nbytes, "flops": flops}

    # The long prompts' 9th chunk (position 2048): alone (B=1), and as the
    # main path's wave, the two long prompts' lanes active among eight.
    out["window_chunk"] = window_case(2048, [True])
    out["window_main"] = window_case(2048, [False] * 6 + [True, True])
    log("kernel_times " + json.dumps(out))
    return out


# -- phase: engine -----------------------------------------------------------------
@contextlib.contextmanager
def plain_attention():
    """Route the model programs through the kernels' plain versions (the
    oracle's arm; the package itself has no such switch)."""
    from nos_tpu_torch.ops import paged_attention as pa

    saved = (pa.paged_decode_attention, pa.paged_window_attention)
    pa.paged_decode_attention = pa._reference
    pa.paged_window_attention = pa._window_reference
    try:
        yield
    finally:
        pa.paged_decode_attention, pa.paged_window_attention = saved


def teacher_forced(torch, params, cfg, prompts, outputs, buckets, block_size, device):
    """Logits of a teacher-forced greedy pass over prompt+output, shaped as
    the engine's own programs: each prompt in chunks of the largest bucket
    (the final one padded to its bucket, batch 1), then the outputs fed
    back through batched single-token decode steps. Returns [n, max_new,
    vocab] f32 logits; row t predicts output token t."""
    from nos_tpu_torch.models import decode as D

    n = len(prompts)
    max_new = len(outputs[0])
    chunk = buckets[-1]
    pages_per = [-(-(len(p) + max_new) // block_size) for p in prompts]
    width = max(pages_per)
    total = 1 + sum(pages_per)
    cache = D.init_paged_cache(cfg, total, block_size, device=device)
    table = torch.zeros((n, width), dtype=torch.int32, device=device)
    nxt = 1
    for i, n_p in enumerate(pages_per):
        table[i, :n_p] = torch.arange(nxt, nxt + n_p, dtype=torch.int32)
        nxt += n_p
    logits = torch.empty((n, max_new, cfg.vocab), dtype=torch.float32, device=device)

    def bucket(m):
        return next((b for b in buckets if b >= m), buckets[-1])

    for i, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            toks = torch.zeros((1, bucket(len(piece))), dtype=torch.int32, device=device)
            toks[0, : len(piece)] = torch.tensor(piece, dtype=torch.int32)
            last = start + len(piece) >= len(prompt)
            lg, _ = D.paged_prefill_chunk(params, toks, cfg, cache, table[i], start,
                                          len(piece), block_size, with_logits=last)
            if last:
                logits[i, 0] = lg[len(piece) - 1]
    out_t = torch.tensor(outputs, dtype=torch.int32, device=device)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    mask = torch.ones((n,), dtype=torch.bool, device=device)
    for t in range(max_new - 1):
        lg, _ = D.paged_decode_step(params, out_t[:, t].contiguous(), cfg, cache, table,
                                    plen + t, mask, block_size)
        logits[:, t + 1] = lg
    return logits


def greedy(torch, logits):
    top = logits.max(dim=-1, keepdim=True).values
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == top, idx, logits.shape[-1]).min(dim=-1).values


def serve(torch, cfg, params, device, prompts, long_prompts, max_new, buckets, max_len):
    """The main path: the short streams first, the long prompts together
    once the streams decode. Returns (outputs in submit order, stats)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.ops import paged_attention as pa

    def engine():
        return DecodeServer(params, cfg, n_slots=8, max_len=max_len,
                            prompt_buckets=buckets, steps_per_dispatch=16,
                            prefill_budget_tokens=2 * buckets[-1], device=device)

    server = engine()
    try:
        # Warm-up (not counted): one short request through both programs.
        server.start()
        server.generate(prompts[0][:40], max_new=20, timeout=600)
        server.stop(drain=True)
        server = engine()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new) for p in prompts]
        server.start()
        while server.steps_run < 2:  # the streams are decoding
            time.sleep(0.001)
        t_long = time.perf_counter()
        futs += [server.submit(p, max_new) for p in long_prompts]
        outs = [f.result(timeout=900) for f in futs]
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        check(len(server.ttft_s) == len(futs), f"{len(server.ttft_s)} TTFT samples")
        stats = {
            "wall_s": wall,
            "decode_tok_per_s": len(futs) * max_new / wall,
            "long_prompt_ttft_s": server.ttft_s[-len(long_prompts):],
            "long_submit_offset_s": t_long - t0,
            "ttft_s": server.ttft_s,
            "queue_wait_s": server.queue_wait_s,
            "macro_dispatches": server.macro_dispatches,
            "prefill_dispatches": server.prefill_dispatches,
            "prefill_window_dispatches": server.prefill_window_dispatches,
            "prefill_tokens": server.prefill_tokens,
            "steps_run": server.steps_run,
            "h2d_uploads": server.h2d_uploads,
            "blocking_syncs": server.blocking_syncs,
            "staging_syncs": server.staging_syncs,
            "ticks_with_prefill_and_macro": server.ticks_with_prefill_and_macro,
            "prefix_hit_tokens": server.prefix_hit_tokens,
            "tick_phase_s": server.tick_phase_s,
            "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
        }
    finally:
        server.stop()
    return outs, stats


def phase_engine(torch, device, dtype, small=False):
    from nos_tpu_torch import GPTConfig, init_gpt

    if small:
        cfg = GPTConfig(vocab=97, hidden=32, layers=2, heads=4, kv_heads=2, max_seq=512,
                        dtype=dtype)
        buckets, max_len, max_new = (8, 16, 32), 512, 12
        lens, long_len = [10, 17, 24, 31, 9, 28], 150
    else:
        cfg = GPTConfig(vocab=32000, hidden=512, layers=8, heads=8, kv_heads=2,
                        max_seq=8192, dtype=dtype)
        buckets, max_len, max_new = (16, 32, 64, 128, 256), 8192, 128
        lens, long_len = [64, 96, 128, 160, 224, 256], 4096
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    long_prompts = [rng.integers(1, cfg.vocab, long_len).tolist() for _ in range(2)]
    outs, stats = serve(torch, cfg, params, device, prompts, long_prompts, max_new,
                        buckets, max_len)
    for o in outs:
        check(len(o) == max_new, f"a future returned {len(o)} tokens, not {max_new}")
    check(stats["prefill_window_dispatches"] > 0,
          "the long prompts' chunks never went through the multi-slot prefill window")
    all_prompts = prompts + long_prompts
    kern = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device)
    with plain_attention():
        plain = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device)
    served = torch.tensor(outs, device=device)
    stats.update(agreement(torch, kern, plain, served, dtype))
    stats["dtype"] = dtype
    if device.type == "cuda" and dtype == "bfloat16":
        stats["step_profile"] = profile_decode_step(torch, cfg, params)
    log(f"engine {dtype}: " + json.dumps(stats))
    return stats


def agreement(torch, kern, plain, served, dtype):
    """The oracle's numbers. `top1_agreement`: the plain arm's greedy pick
    (lowest index among exact maxima) equals the served token, as
    runtime/divergence.py counts it. `top1_agreement_ties`: the served
    token attains the plain arm's maximum (exact ties count).
    `top1_agreement_1ulp`: the served token's plain logit lies within one
    rounding step of the logits' dtype below the plain maximum; in bf16 a
    32000-token vocabulary puts the top two logits in one or two adjacent
    bf16 steps at a few percent of positions, and which of them the
    lowest-index rule picks then turns on sub-step differences of the
    attention output's rounding. Also: the gaps of the disagreements in
    those steps, the share of exactly tied plain top-2, the kernel arm's
    agreement with the served tokens, and max and mean |dlogit| between
    the arms."""
    top = plain.max(dim=-1).values
    served_logit = plain.gather(-1, served[..., None].long())[..., 0]
    top2 = plain.topk(2, dim=-1).values
    mant = 7 if dtype == "bfloat16" else 23  # explicit mantissa bits of the head's output
    step = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - mant)
    gap = (top - served_logit) / step
    miss = gap[greedy(torch, plain) != served]
    return {
        "top1_agreement": (greedy(torch, plain) == served).float().mean().item(),
        "top1_agreement_ties": (served_logit == top).float().mean().item(),
        "top1_agreement_1ulp": (gap <= 1.0).float().mean().item(),
        "disagreement_gap_steps": sorted(miss.tolist()),
        "plain_top2_tied": (top2[..., 0] == top2[..., 1]).float().mean().item(),
        "top1_agreement_kernel_arm": (greedy(torch, kern) == served).float().mean().item(),
        "max_abs_dlogit": (kern - plain).abs().max().item(),
        "mean_abs_dlogit": (kern - plain).abs().mean().item(),
        "finite": bool(torch.isfinite(kern).all().item()
                       and torch.isfinite(plain).all().item()),
    }


def check_engine(stats):
    """The teacher-forced oracle's bounds (runtime/divergence.py:43,48:
    max|dlogit| <= 0.5, top-1 agreement >= 0.98). In float32 the served
    tokens must be the plain programs' greedy picks at every position. In
    bf16 the strict rate is printed, not gated: a random model's flat
    32000-token logits put the plain top two within one bf16 step at a
    few percent of positions, where the lowest-index pick turns on
    sub-step rounding of the attention output (PERF.md). The bf16 gate
    counts a served token within one step of the plain maximum as a
    top-1 pick, and holds the kernel arm's logits against the plain
    arm's at limits pinned from measured runs."""
    dtype = stats["dtype"]
    check(stats["finite"], f"engine {dtype}: non-finite logits")
    check(stats["max_abs_dlogit"] <= 0.5,
          f"engine {dtype}: max|dlogit| {stats['max_abs_dlogit']} > 0.5")
    if dtype == "float32":
        check(stats["top1_agreement"] == 1.0,
              f"engine float32: top-1 agreement {stats['top1_agreement']} < 1.0")
        return
    check(stats["top1_agreement_1ulp"] >= 0.98,
          f"engine {dtype}: top-1 agreement within a step "
          f"{stats['top1_agreement_1ulp']} < 0.98")
    check(stats["max_abs_dlogit"] <= MAX_DLOGIT_BF16,
          f"engine {dtype}: max|dlogit| {stats['max_abs_dlogit']} > {MAX_DLOGIT_BF16}")
    check(stats["mean_abs_dlogit"] <= MEAN_DLOGIT_BF16,
          f"engine {dtype}: mean|dlogit| {stats['mean_abs_dlogit']} > {MEAN_DLOGIT_BF16}")


def profile_decode_step(torch, cfg, params, steps=16):
    """Where one macro window's time goes: 16 decode steps at the main
    path's B=8 lanes under torch.profiler. Host wall per step, device
    kernel time per step (sum of CUDA kernel intervals; one stream, so no
    overlap), kernels launched per step, and the attention kernel's
    share."""
    from torch.profiler import ProfilerActivity, profile

    from nos_tpu_torch.models import decode as D

    B, BS = 8, 32
    P = -(-max(MAIN_DECODE_LIMITS) // BS) + 1
    cache = D.init_paged_cache(cfg, 1 + B * P, BS, device="cuda")
    table = (torch.arange(B * P, dtype=torch.int32, device="cuda") + 1).reshape(B, P)
    pos0 = torch.tensor(MAIN_DECODE_LIMITS, dtype=torch.int32, device="cuda") - 1
    token = torch.ones((B,), dtype=torch.int32, device="cuda")
    mask = torch.ones((B,), dtype=torch.bool, device="cuda")

    def run():
        for k in range(steps):
            D.paged_decode_step(params, token, cfg, cache, table, pos0 + k, mask, BS)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels, dev_us, attn_us = 0, 0.0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            us = e.time_range.elapsed_us()
            dev_us += us
            if "paged_attention" in e.name:
                attn_us += us
    return {
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "device_busy_share": (dev_us / 1e6) / wall if wall else None,
        "kernels_per_step": n_kernels / steps,
        "attention_ms_per_step": attn_us / 1e3 / steps,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,card,kernels,engine")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny model on the CPU through the plain versions; no result line")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        import nos_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (nos_tpu_torch not found)",
              file=sys.stderr)
        return 2
    if args.rehearse:
        check_engine(phase_engine(torch, torch.device("cpu"), "float32", small=True))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "build" in phases:
        phase_build()
    if "card" in phases:
        phase_card(torch)
    worst, timings = None, None
    if "kernels" in phases:
        worst, timings = phase_kernels(torch)
    engine = None
    if "engine" in phases:
        engine = phase_engine(torch, torch.device("cuda"), "bfloat16")
        engine_f32 = phase_engine(torch, torch.device("cuda"), "float32")
        check_engine(engine)
        check_engine(engine_f32)
    log(f"total_s={time.perf_counter() - t0:.1f}")
    if worst is None or engine is None:
        return 0
    launches = engine["launches"]
    for name in ("paged_decode_attention", "paged_window_attention"):
        check(launches.get(name, 0) > 0, f"{name} never launched on the main path")
    main_key = {"paged_decode_attention": "decode_main",
                "paged_window_attention": "window_main"}
    replaces = {"paged_decode_attention": "nos_tpu/ops/paged_attention.py:62",
                "paged_window_attention": "nos_tpu/ops/paged_attention.py:288"}
    kernels = []
    for name in ("paged_decode_attention", "paged_window_attention"):
        t = timings[main_key[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nos_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
