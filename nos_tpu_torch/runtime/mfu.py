"""Port of `nos_tpu/runtime/mfu.py` (:1-459): model FLOP/s as a share of
the card's peak (MFU), measured on the card.

`device_peak_flops` (:38) matches the device's name against a table of
dense bf16 data-sheet peaks, longest match first; here the table holds the
H100's parts, and a device that is not CUDA has no peak (None).
`measure_mfu` (:96) times `fn(*args)` by loop differencing: an eager loop
of `length` calls between two CUDA events against a loop a quarter as
long, the minimum of `repeats` each, the adaptive doubling of the loop
length (:145-169) under a cap, and the reference's dict. Its FLOP count is
the caller's analytic `flops`, or else `count_flops`, which runs one call
under `torch.utils.flop_counter.FlopCounterMode`. `vit_batch_mfu` (:194)
and `gpt_train_mfu` (:221) measure the detector's batch and the GPT train
step; `flash_train_shape_speedup` (:289) times the flash pair against the
plain materializing attention by the same differencing, gated by
`accept_flash_walls` (:375, copied verbatim). `gpt_train_flops` (:438)
and `flash_pair_floor_ms` (:268) are copies.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from nos_tpu_torch.device import resolve

H100_BF16_PEAK_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
# measure_mfu starts no round of loops that would end after this many
# seconds of timing (a ~233 ms train step reaches it at 16 calls a loop).
LOOP_BUDGET_S = 30.0

# Peak dense bf16 FLOP/s per card, from NVIDIA's H100 data sheet, keyed by
# substrings of the name `torch.cuda.get_device_name` reports, lower-cased
# (the SXM part reports as "NVIDIA H100 80GB HBM3").
PEAK_BF16_FLOPS: Dict[str, float] = {
    "h100": H100_BF16_PEAK_FLOPS,  # SXM
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
}


def kind_peak_flops(kind: str) -> Optional[float]:
    """The peak of a device named `kind`: the longest table key that is a
    substring of it ("h100 pcie" before "h100"), or None."""
    kind = kind.lower()
    best = None
    for sub, peak in PEAK_BF16_FLOPS.items():
        if sub in kind and (best is None or len(sub) > len(best[0])):
            best = (sub, peak)
    return best[1] if best else None


def device_peak_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of `device`; None off CUDA or for a card the
    table does not know."""
    if torch.device(device).type != "cuda":
        return None
    return kind_peak_flops(torch.cuda.get_device_name(device))


def count_flops(fn: Callable, args: tuple) -> float:
    """FLOPs of one `fn(*args)` by `FlopCounterMode`, which counts the
    aten operators it dispatches (matrix products, convolutions, SDPA).
    The hand kernels launch through ctypes and never reach it, so a
    function that launches one is undercounted: pass such a function's
    FLOPs to `measure_mfu` analytically."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _loop_walls(fn: Callable, args: tuple, length: int, repeats: int, device):
    """(min, second-min) seconds of `length` calls of `fn(*args)` between
    two CUDA events, each repeat started from an idle card. One call first
    takes the first-call costs (allocator growth, library handles). The
    events read the card's clock, so a loop the host cannot feed fast
    enough reads the host's pace: that is the step time a caller gets.
    Min, not median: interference only adds time. The min->second-min gap
    is the noise scale the adaptive loop weighs the signal against."""
    fn(*args)
    walls = []
    with torch.cuda.device(device):
        for _ in range(repeats):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(length):
                fn(*args)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end) / 1e3)
    walls.sort()
    return walls[0], walls[min(1, len(walls) - 1)]


def measure_mfu(
    fn: Callable,
    args: tuple,
    scan_length: int = 32,
    repeats: int = 5,
    flops: Optional[float] = None,
    device=None,
) -> Optional[dict]:
    """Measure `fn(*args)`'s step time on `device` (None: CUDA) and its MFU.

    Each loop calls `fn(*args)` `length` times in a row. The reference
    perturbs its first argument by the scan's carry so that XLA can
    neither hoist nor merge the loop body; eager PyTorch does neither, so
    each call runs in full on the same arguments, and a function that
    updates its arguments in place (the train step's params and moments)
    chains one call into the next. `flops` is the FLOPs of one call; left
    None, `count_flops` counts them, which misses the hand kernels: pass
    an analytic count for any function that reaches one (as
    `gpt_train_mfu` does).

    The loop length doubles from `scan_length` (at least 8) until the long
    loop's lead over the short one clears 4x the noise and the rate is
    within the peak, up to max(512, scan_length) calls and while the next
    round fits in what is left of LOOP_BUDGET_S. Returns None where the peak is unknown (off CUDA),
    and where the rate exceeds the peak even at the last length: the
    difference then drowned in noise, and a wrong number is worse than
    none."""
    device = resolve(device, "measure_mfu")
    peak = device_peak_flops(device)
    if peak is None:
        return None

    flops_source = "analytic"
    if flops is None:
        flops = count_flops(fn, args)
        flops_source = "flop_counter"

    scan_length = max(scan_length, 8)
    max_scan_length = max(512, scan_length)
    t0 = time.perf_counter()
    while True:
        short = max(2, scan_length // 4)
        wall_short, wall_short2 = _loop_walls(fn, args, short, repeats, device)
        wall_n, wall_n2 = _loop_walls(fn, args, scan_length, repeats, device)
        delta = wall_n - wall_short
        noise = (wall_short2 - wall_short) + (wall_n2 - wall_n)
        step_s = max(delta / (scan_length - short), 1e-9)
        achieved = flops / step_s
        solid = delta > 4.0 * noise and achieved <= peak
        # The next round: 2.5x this round's calls at this round's pace.
        next_s = 2.5 * repeats * (wall_n + wall_short)
        if (solid or 2 * scan_length > max_scan_length
                or time.perf_counter() - t0 + next_s > LOOP_BUDGET_S):
            break
        scan_length *= 2
    if achieved > peak:
        return None
    # The delta is known to +-noise.
    span = scan_length - short
    step_lo = max(delta - noise, 1e-9) / span
    step_hi = (delta + noise) / span
    return {
        "device_kind": torch.cuda.get_device_name(device),
        "flops_source": flops_source,
        "flops_per_step": flops,
        "step_time_s": step_s,
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": peak / 1e12,
        "mfu": achieved / peak,
        "mfu_range": (
            flops / step_hi / peak,
            min(flops / step_lo / peak, 1.0),
        ),
        "scan_length": scan_length,
        "dispatch_overhead_s": max(wall_short - short * step_s, 0.0),
    }


def vit_batch_mfu(batch: int = 7, scan_length: int = 64, device=None,
                  generator: Optional[torch.Generator] = None, **kw) -> Optional[dict]:
    """MFU of the detector's batch step, `vit_detect` on `batch` images
    (batch 7: the seven workloads that share one card in bench.py's
    headline cell) of `ViTConfig()` (YOLOS-small at 224 px, bf16), params
    and images drawn from `generator` (default seed 0) on `device` (None:
    CUDA). At 224 px attention stays below the flash
    kernel's threshold, so `count_flops` sees every product. The CUDA
    events need no long loop to cancel a dispatch round trip, so the loop
    starts at 64 calls. None off CUDA."""
    from nos_tpu_torch.models.vit import ViTConfig, init_vit, vit_detect

    device = resolve(device, "vit_batch_mfu")
    if device_peak_flops(device) is None:
        return None
    cfg = ViTConfig()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_vit(cfg, generator, device=device)
    images = torch.rand((batch, cfg.image_size, cfg.image_size, 3), generator=generator)
    images = images.to(device)
    return measure_mfu(lambda ims: vit_detect(params, ims, cfg), (images,),
                       scan_length=scan_length, device=device, **kw)


def gpt_train_mfu(batch: int = 8, seq: Optional[int] = None, cfg=None, state=None,
                  device=None, generator: Optional[torch.Generator] = None,
                  **kw) -> Optional[dict]:
    """MFU of the GPT train step (forward, backward and the AdamW update)
    at hidden 2048 x 8 layers, batch 8 x seq 2048 unless `cfg` (a
    TrainConfig) says otherwise, counted by `gpt_train_flops` (the flash
    kernels are invisible to `count_flops`). `state` is a (params,
    opt_state) pair of `init_train_state(cfg)` to time in place of a fresh
    one (drawn from `generator`, default seed 0, on `device`, None:
    CUDA); the step updates it in place, so every timed call runs the
    whole step from the state the last one left. Tokens are uniform,
    drawn from `generator`. None off CUDA."""
    from nos_tpu_torch.models.gpt import GPTConfig
    from nos_tpu_torch.models.train import TrainConfig, init_train_state, make_train_step

    device = resolve(device, "gpt_train_mfu")
    if device_peak_flops(device) is None:
        return None
    cfg = cfg or TrainConfig(model=GPTConfig(hidden=2048, layers=8))
    seq = seq or cfg.model.max_seq
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params, opt_state = state or init_train_state(cfg, generator, device=device)
    tokens = torch.randint(0, cfg.model.vocab, (batch, seq), generator=generator,
                           dtype=torch.int32).to(device)
    return measure_mfu(make_train_step(cfg), (params, opt_state, tokens),
                       flops=gpt_train_flops(cfg.model, batch, seq), device=device, **kw)


def flash_pair_floor_ms(
    batch: int, heads: int, seq: int, head_dim: int, peak_flops: float
) -> float:
    """Least time of a causal flash attention forward + backward pair, in
    ms: at least 8 * b * h * s^2 * d matmul FLOPs (QK^T and PV forward, the
    backward's dQ/dK/dV/dP products and its recompute of QK^T from the
    saved lse) at `peak_flops`."""
    return 8.0 * batch * heads * seq * seq * head_dim / peak_flops * 1e3


def flash_train_shape_speedup(
    batch: int = 8, heads: int = 8, seq: int = 2048, head_dim: int = 64,
    scan_length: int = 32, repeats: int = 5, attempts: int = 3, device=None,
    generator: Optional[torch.Generator] = None,
) -> Optional[dict]:
    """Forward + backward (the gradient of q) of the flash pair, bf16 and
    causal, against the plain materializing attention
    (`_reference_attention` under autograd) at the training attention
    shape, each timed by the loop differencing of `measure_mfu`, in
    `attempts` interleaved measurements; `accept_flash_walls` publishes
    each side's minimum only when a second wall corroborates it. q, k and
    v are normal, drawn from `generator` (default seed 0). None without
    CUDA (`device` None) or on a device that is not CUDA."""
    from nos_tpu_torch.ops import flash_attention as fa

    if device is None and not torch.cuda.is_available():
        return None
    device = resolve(device, "flash_train_shape_speedup")
    if device.type != "cuda":
        return None
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scale = head_dim ** -0.5
    shape = (batch, heads, seq, head_dim)
    q, k, v = (torch.randn(shape, generator=generator).to(device, torch.bfloat16)
               for _ in range(3))

    def step_of(attn):
        qq = q.detach().requires_grad_()

        def step():
            out = attn(qq, k, v)
            (g,) = torch.autograd.grad(out.float().sum() * 1e-6, qq)
            return g

        return step

    flash_step = step_of(lambda qq, kk, vv: fa.flash_attention(qq, kk, vv, causal=True))
    ref_step = step_of(lambda qq, kk, vv: fa._reference_attention(qq, kk, vv, True, scale))

    peak = device_peak_flops(device)
    floor_ms = flash_pair_floor_ms(batch, heads, seq, head_dim, peak) if peak else 0.0

    def measure(step):
        short = max(2, scan_length // 4)
        w_short, _ = _loop_walls(step, (), short, repeats, device)
        w_n, _ = _loop_walls(step, (), scan_length, repeats, device)
        delta = w_n - w_short
        if delta <= 0:
            # No signal: clamping it would fabricate a huge speedup.
            return None
        ms = delta / (scan_length - short) * 1e3
        if ms < floor_ms:
            # Below the analytic floor at the peak: not a real time.
            return None
        return ms

    flash_walls, ref_walls = [], []
    rejected = {"flash": 0, "reference": 0}
    for _ in range(max(1, attempts)):
        f_ms = measure(flash_step)
        r_ms = measure(ref_step)
        if f_ms is not None:
            flash_walls.append(f_ms)
        else:
            rejected["flash"] += 1
        if r_ms is not None:
            ref_walls.append(r_ms)
        else:
            rejected["reference"] += 1
    return accept_flash_walls(
        flash_walls, ref_walls, floor_ms, rejected, list(shape)
    )


def accept_flash_walls(
    flash_walls: list,
    ref_walls: list,
    floor_ms: float,
    rejected: dict,
    shape: list,
    consistency_factor: float = 1.5,
) -> dict:
    """Publication gate for the flash speedup walls, pure so that tests
    can feed it synthetic wall sets. Each side's minimum publishes only
    when CORROBORATED: a second wall must lie within `consistency_factor`
    of it. An empty side or an outlier minimum with no second wall near it
    is emitted as the `invalid` marker, never as a number."""

    def corroborated(walls: list) -> bool:
        if len(walls) < 2:
            return False
        lo = min(walls)
        return sum(1 for w in walls if w <= lo * consistency_factor) >= 2

    base = {
        "floor_ms": floor_ms,
        "rejected_attempts": rejected,
        "flash_walls_ms": flash_walls,
        "reference_walls_ms": ref_walls,
        "shape": shape,
    }
    if not flash_walls or not ref_walls:
        return {
            "invalid": "all attempts rejected (delta<=0 or below analytic floor)",
            **base,
        }
    if not corroborated(flash_walls) or not corroborated(ref_walls):
        return {
            "invalid": (
                "uncorroborated minimum: no second wall within "
                f"{consistency_factor}x of min on both sides"
            ),
            **base,
        }
    # Each side's minimum across attempts, walls emitted unrounded.
    out = {
        "flash_ms": min(flash_walls),
        "reference_ms": min(ref_walls),
        **base,
    }
    out["speedup"] = out["reference_ms"] / out["flash_ms"]
    return out


def gpt_train_flops(model, batch: int, seq: int) -> float:
    """Analytic model FLOPs of one train step (fwd + bwd): 6 x matmul
    params x tokens, plus the causal attention term counted at seq^2/2 (the
    useful work of a causal model). Recompute under remat is excluded, so
    remat shows up as lower MFU."""
    h = model.hidden
    kv_dim = model.n_kv * model.head_dim
    per_layer = 2 * h * h + 2 * h * kv_dim + 3 * h * (h * model.mlp_ratio)
    matmul_params = model.layers * per_layer + h * model.vocab  # + lm_head
    tokens = batch * seq
    dense = 6.0 * matmul_params * tokens
    attention = 3.0 * model.layers * (4.0 * batch * (seq * seq / 2.0) * h)
    return dense + attention
