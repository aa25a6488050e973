"""The dropless top-k expert layer for serving: a hand-written CUDA kernel
chain for Hopper (`csrc/moe_experts.cu`), with its plain PyTorch version
beside it.

It replaces no TPU kernel: the JAX package's expert layer is the training
one (`parallel/moe.py`: capacity-based dropping, top-1/2, einsums over
padded capacity buffers), which a served model with 64 experts and 8 of
them a token cannot use. This layer drops nothing.

What it computes, for normed activations x [T, h] and a row mask `valid`
[T] (None: every row): router logits x @ router in float32, a softmax over
all experts, the top_k with ties to the lowest index, those weights
renormalized over the top_k (`norm_topk_prob`); then for each chosen
(token, expert) y = (silu(x W_gate[e]) * (x W_up[e])) W_down[e], and each
token's output the weighted sum of its top_k rows in order k = 0, 1, ...
A masked row takes no expert and its output is 0.

The CUDA route (bf16 only): the router logits are a float32 matrix product
(cuBLAS, no TF32), then one call into the library launches five kernels:
routing (softmax, top-k, per-expert counts), a counting sort of the rows
by expert (offsets by a prefix sum on the device, a deterministic order
within an expert), the grouped gate|up GEMM with silu(gate) * up in its
epilogue, the grouped down GEMM, and the combine of each token's rows in
order, with no atomics on data. Nothing reads the counts back: the GEMMs'
grids are sized for the worst case, T * top_k rows, and their empty tiles
exit at once, so CUDA graphs capture the layer. The plain route serves the
CPU: the same routing in float32, the experts' products over their routed
rows only.

`tally` (an int64 [2] tensor on x's device, or None) gathers the layer's
work on the device: `tally[0]` += rows routed (valid rows x top_k),
`tally[1]` += experts that got at least one row. `LAUNCHES` counts the
kernel chain's calls, and `ROUTE_LAUNCHES` the same calls by route, as the
other kernel wrappers count theirs.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nos_tpu_torch.ops import _build

#: Calls of the CUDA chain (each launches its five kernels).
LAUNCHES: Dict[str, int] = {"moe_experts": 0}
#: The same calls by entry point and route.
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {"moe_experts": {"grouped": 0}}



def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = {"grouped": 0}


#: The kernels' limits (csrc/moe_experts.cu).
MAX_EXPERTS = 64
MAX_TOP_K = 32


def route(x, router, top_k: int, norm_topk_prob: bool):
    """(ids [T, top_k] int64, weights [T, top_k] f32): float32 softmax over
    the experts, the top_k in order of weight with ties to the lowest index
    (a stable sort), renormalized by their sum taken in that order."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    if norm_topk_prob:
        total = w[:, 0]
        for k in range(1, top_k):
            total = total + w[:, k]
        w = w / total[:, None]
    return ids, w


def _plain(x, router, w_gate, w_up, w_down, top_k, norm_topk_prob, valid, tally):
    t, h = x.shape
    ids, w = route(x, router, top_k, norm_topk_prob)
    if valid is not None:
        w = w * valid[:, None].to(w.dtype)
        ids = torch.where(valid[:, None], ids, torch.full_like(ids, w_gate.shape[0]))
    rows = torch.zeros((t, top_k, h), dtype=x.dtype, device=x.device)
    hits = torch.zeros((), dtype=torch.int64, device=x.device)
    for e in range(w_gate.shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        hits = hits + (tok.numel() > 0)
        if tok.numel():
            xe = x[tok]
            mid = (F.silu((xe @ w_gate[e]).float()) * (xe @ w_up[e]).float()).to(x.dtype)
            rows[tok, slot] = mid @ w_down[e]
    out = w[:, 0, None] * rows[:, 0].float()
    for k in range(1, top_k):
        out = out + w[:, k, None] * rows[:, k].float()
    if tally is not None:
        n = t if valid is None else valid.sum()
        tally[0] += n * top_k
        tally[1] += hits
    return out.to(x.dtype)


# -- the CUDA chain --------------------------------------------------------------
_VP, _I = _build.VP, _build.I
_SIGNATURES = {"nos_moe_experts": [_VP] * 17 + [_I] * 7 + [_VP]}
_counts: Dict[torch.device, torch.Tensor] = {}
_lock = threading.Lock()


def _lib():
    return _build.load("moe_experts", _SIGNATURES)


def _expert_counts(device) -> torch.Tensor:
    """The routing kernel's per-expert counters on `device`, zeroed once
    and kept: the sort kernel reads and clears them, so every launch leaves
    them at 0 (a captured graph's replays too)."""
    with _lock:
        cnt = _counts.get(device)
        if cnt is None:
            cnt = _counts[device] = torch.zeros(MAX_EXPERTS, dtype=torch.int32, device=device)
        return cnt


def _kernel(x, router, w_gate, w_up, w_down, top_k, norm_topk_prob, valid, tally):
    require = _build.require
    t, h = x.shape
    e, _, f = w_gate.shape
    dev = x.device
    require(x.dtype == torch.bfloat16, "the expert kernels take bf16, got {}", x.dtype)
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        require(w.dtype == torch.bfloat16 and w.is_contiguous() and w.device == dev,
                "{} must be contiguous bf16 on {}", name, dev)
    require(w_up.shape == (e, h, f) and w_down.shape == (e, f, h) and router.shape == (h, e),
            "expert weights must be [E, h, f], [E, h, f], [E, f, h] and the router [h, E]")
    require(0 < e <= MAX_EXPERTS and 0 < top_k <= min(e, MAX_TOP_K),
            "experts ({}) and top_k ({}) out of the kernels' range", e, top_k)
    require(h % 128 == 0 and f % 64 == 0, "hidden must be a multiple of 128 and the expert "
            "width of 64, got {} and {}", h, f)
    x = x.contiguous()
    if valid is not None:
        valid = valid.contiguous()
        require(valid.dtype == torch.bool and valid.shape == (t,), "valid must be [T] bool")
    if tally is not None:
        require(tally.dtype == torch.int64 and tally.shape == (2,) and tally.is_contiguous()
                and tally.device == dev, "tally must be [2] int64 on {}", dev)
    logits = x.float() @ router.float()
    rows = t * top_k
    ids = torch.empty(rows, dtype=torch.int32, device=dev)
    wts = torch.empty(rows, dtype=torch.float32, device=dev)
    offs = torch.empty(2 * (e + 1), dtype=torch.int32, device=dev)  # rows, then tiles
    perm = torch.empty(rows, dtype=torch.int32, device=dev)
    slot_of = torch.empty(rows, dtype=torch.int32, device=dev)
    mid = torch.empty((rows, f), dtype=torch.bfloat16, device=dev)
    ys = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    ptr = [_VP(a.data_ptr()) if a is not None else None for a in (
        x, logits, valid, w_gate, w_up, w_down, ids, wts, _expert_counts(dev), offs,
        offs[e + 1:], perm, slot_of, mid, ys, out, tally)]
    # The grouped GEMMs' row tile: 16 where an expert averages at most 16
    # rows (decode), else 64 (prefill chunks).
    bm = 16 if rows <= 16 * e else 64
    lib = _lib()
    rc = lib.nos_moe_experts(*ptr, t, h, f, e, top_k, int(bool(norm_topk_prob)), bm,
                             _build.stream(x))
    _build.raise_on(lib, rc, "moe_experts")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, "moe_experts", "grouped")
    return out


def moe_experts(x, router, w_gate, w_up, w_down, top_k: int, norm_topk_prob: bool = True,
                valid: Optional[torch.Tensor] = None, tally: Optional[torch.Tensor] = None):
    """The expert layer on normed x [T, h] (see the module docstring): router
    [h, E], w_gate / w_up [E, h, f], w_down [E, f, h]. Returns [T, h] in x's
    dtype. CUDA tensors launch the kernel chain; CPU tensors take the plain
    version."""
    if x.device.type == "cuda":
        return _kernel(x, router, w_gate, w_up, w_down, top_k, norm_topk_prob, valid, tally)
    if x.device.type != "cpu":
        raise ValueError(f"the expert layer runs on cuda or cpu, not {x.device}")
    return _plain(x, router, w_gate, w_up, w_down, top_k, norm_topk_prob, valid, tally)
