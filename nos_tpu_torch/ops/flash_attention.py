"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper, with their plain PyTorch versions beside them.

Port of `nos_tpu/ops/flash_attention.py`. The TPU ran the forward
(`_flash_fwd_pallas` :77) and the FlashAttention-2 backward
(`_flash_bwd_pallas` :190: `dq_kernel` :234, `dkv_kernel` :287) as Pallas
kernels under a `custom_vjp` (:365-394); here the same three kernels live
in `csrc/flash_attention.cu` (see its header for the design), built with
nvcc and bound with ctypes (`ops/_build.py`), under a
`torch.autograd.Function` (`_Flash`).

`flash_attention` dispatches on the tensors' device: CUDA tensors always
launch the kernels (a failed build or launch raises, nothing falls back),
CPU tensors take the plain versions through the same `_Flash`, so the CPU
tests cover the autograd wiring. The plain versions compute what the Pallas
kernels compute, in f32, over the whole [T, T] score matrix:
`_flash_fwd_reference` -> (o, lse), `_flash_bwd_reference` -> (dq, dk, dv).
`_reference_attention` (:39) is the reference's XLA path op for op.
`LAUNCHES` counts kernel launches per kernel, so a run can show that its
main path went through them, and `ROUTE_LAUNCHES` the same launches by
route: each of the three kernels takes "mma", a tensor-core kernel, for
bf16 inputs (`_flash_route`), and "simt" for f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nos_tpu_torch.ops import _build

# The reference's Pallas block sizes (:34-35). `flash_attention` takes them
# for the reference's signature; the CUDA kernels tile by their own sizes.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30

#: Kernel launches per kernel (incremented only where a kernel launches).
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
}

#: The same launches by kernel and route ("mma" or "simt").
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {name: {"mma": 0, "simt": 0} for name in LAUNCHES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = {"mma": 0, "simt": 0}


def _flash_route(q) -> str:
    """The route of the forward, dq and dk/dv kernels alike, a pure
    function of dtype and shape: "mma" (the tensor-core kernels) for bf16
    at head_dim 64, 128 or 256, "simt" otherwise (f32; the kernels take no
    other head_dim, and the simt kernels refuse bf16)."""
    return "mma" if q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS else "simt"


# -- plain versions ------------------------------------------------------------
def _reference_attention(q, k, v, causal: bool, scale: float):
    """The reference's XLA attention (:39): q*scale in q's dtype, f32
    scores, softmax, the weights cast to v's dtype before PV."""
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril(t_k - t_q)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def _valid(t: int, causal: bool, device) -> Optional[torch.Tensor]:
    """The kernels' mask over [T, T] (None: every entry valid)."""
    if not causal:
        return None
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """What the forward kernel computes (:102-159), whole-row: s = (q*scale)
    k^T in f32, masked weights zeroed, the weights cast to v's dtype before
    PV, o = acc / max(l, 1e-30); lse [B,H,T] f32, NEG_INF on a row with no
    valid key. -> (o in q's dtype, lse)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    valid = _valid(q.shape[-2], causal, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    den = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / den[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(den), torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse


def _dvec(o, do):
    """D = rowsum(dO * O) in f32 (:213): [B,H,T]."""
    return (do.float() * o.float()).sum(dim=-1)


def _probs(q, k, lse, causal: bool, scale: float):
    """The backward's recomputed weights (:248-250, :303-305): exp(q k^T *
    scale - lse), zeroed where masked, f32 [B,H,T,T]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    valid = _valid(q.shape[-2], causal, q.device)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    return p


def _dq_reference(q, k, v, do, lse, dvec, causal: bool, scale: float):
    """What `dq_kernel` computes (:234-267), in f32."""
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - dvec[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(q.dtype)


def _dkv_reference(q, k, v, do, lse, dvec, causal: bool, scale: float):
    """What `dkv_kernel` computes (:287-327), in f32: (dk, dv)."""
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - dvec[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_reference(q, k, v, o, lse, do, causal: bool, scale: float):
    """The FlashAttention-2 backward (:190) from the saved lse, in f32 ->
    (dq, dk, dv)."""
    dvec = _dvec(o, do)
    dq = _dq_reference(q, k, v, do, lse, dvec, causal, scale)
    dk, dv = _dkv_reference(q, k, v, do, lse, dvec, causal, scale)
    return dq, dk, dv


def flash_err(got, want) -> float:
    """The measure a kernel's output is held to against its plain
    version's (chip_smoke.py, tests/test_torch_kernels.py): the worst
    |got - want| / (|want| + r) over every entry, r the rms of the entry's
    row (the last axis) floored at 1% of the whole tensor's rms. Each entry
    is held against its own size and its row's, so a fault on a few rows
    or keys shows however small their values are; the floor holds a row
    that is all rounding noise (dq's first row under a causal mask is zero
    in exact arithmetic) at the tensor's scale."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    floor = 1e-2 * w.pow(2).mean().sqrt()
    return ((g - w).abs() / (w.abs() + rms.clamp_min(floor))).max().item()


# -- the CUDA kernels ----------------------------------------------------------
_VP, _I = _build.VP, _build.I
_require = _build.require
_SIGNATURES = {
    "nos_flash_fwd": [_VP] * 5 + [_I] * 5 + [_build.F, _VP],
    "nos_flash_fwd_mma": [_VP] * 5 + [_I] * 4 + [_build.F, _VP],
    "nos_flash_bwd_dq": [_VP] * 7 + [_I] * 5 + [_build.F, _VP],
    "nos_flash_bwd_dq_mma": [_VP] * 7 + [_I] * 4 + [_build.F, _VP],
    "nos_flash_bwd_dkv": [_VP] * 8 + [_I] * 5 + [_build.F, _VP],
    "nos_flash_bwd_dkv_mma": [_VP] * 8 + [_I] * 4 + [_build.F, _VP],
}


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def _check(q, *others) -> Tuple[int, int, int]:
    """q and the [B,H,T,D] tensors beside it: one CUDA device, one dtype
    (f32 or bf16), one shape, contiguous, D in 64/128/256. The f32 [B,H,T]
    rows (lse, D) are checked by the callers. Returns (bh, t, d)."""
    _require(q.dim() == 4, f"flash attention takes [B, H, T, D], got {tuple(q.shape)}")
    _require(q.dtype in _DTYPE_CODE, f"q must be float32 or bfloat16, got {q.dtype}")
    for x in (q, *others):
        _require(x.device == q.device and x.dtype == q.dtype and x.shape == q.shape,
                 "q, k, v (and o, dO) must share device, dtype and shape")
        _require(x.is_contiguous(), "the kernels take contiguous tensors only")
    b, h, t, d = q.shape
    _require(d in _HEAD_DIMS, f"head_dim must be one of {_HEAD_DIMS}, got {d}")
    _require(t > 0 and b * h > 0, "empty attention")
    return b * h, t, d


def _check_rows(q, *rows) -> None:
    for r in rows:
        _require(r.dtype == torch.float32 and r.shape == q.shape[:3] and r.is_contiguous()
                 and r.device == q.device, "lse and D must be [B, H, T] float32 on q's device")


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The forward kernel on CUDA tensors -> (o, lse [B,H,T] f32)."""
    bh, t, d = _check(q, k, v)
    route = _flash_route(q)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib()
    ptrs = [_VP(x.data_ptr()) for x in (q, k, v, o, lse)]
    if route == "mma":
        rc = lib.nos_flash_fwd_mma(*ptrs, bh, t, d, int(causal), scale, _build.stream(q))
    else:
        rc = lib.nos_flash_fwd(*ptrs, bh, t, d, _DTYPE_CODE[q.dtype], int(causal), scale,
                               _build.stream(q))
    _build.raise_on(lib, rc, f"flash_fwd ({route})")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, "flash_fwd", route)
    return o, lse


def _bwd(name, q, k, v, do, lse, dvec, outs, causal: bool, scale: float) -> None:
    """Launch backward kernel `name` (flash_bwd_dq or flash_bwd_dkv) on its
    route, writing `outs` (dq, or dk and dv)."""
    bh, t, d = _check(q, k, v, do)
    _check_rows(q, lse, dvec)
    route = _flash_route(q)
    lib = _lib()
    ptrs = [_VP(x.data_ptr()) for x in (q, k, v, do, lse, dvec, *outs)]
    if route == "mma":
        rc = getattr(lib, f"nos_{name}_mma")(*ptrs, bh, t, d, int(causal), scale,
                                             _build.stream(q))
    else:
        rc = getattr(lib, f"nos_{name}")(*ptrs, bh, t, d, _DTYPE_CODE[q.dtype], int(causal),
                                         scale, _build.stream(q))
    _build.raise_on(lib, rc, f"{name} ({route})")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, name, route)


def flash_bwd_dq(q, k, v, do, lse, dvec, causal: bool, scale: float):
    """The dq kernel on CUDA tensors -> dq."""
    dq = torch.empty_like(q)
    _bwd("flash_bwd_dq", q, k, v, do, lse, dvec, (dq,), causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dvec, causal: bool, scale: float):
    """The dk/dv kernel on CUDA tensors -> (dk, dv)."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bwd("flash_bwd_dkv", q, k, v, do, lse, dvec, (dk, dv), causal, scale)
    return dk, dv


# -- autograd and the public entry point -----------------------------------------
def _on_cuda(q) -> bool:
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _Flash(torch.autograd.Function):
    """The reference's `custom_vjp` `_flash` (:365-394): the forward saves
    q, k, v, o and lse; the backward forms D = rowsum(dO * O) and runs the
    dq and dkv kernels (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _on_cuda(q):
            o, lse = flash_fwd(q, k, v, causal, scale)
        else:
            o, lse = _flash_fwd_reference(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # it arrives through _attention's transpose
        if _on_cuda(q):
            dvec = _dvec(o, do)
            dq = flash_bwd_dq(q, k, v, do, lse, dvec, ctx.causal, ctx.scale)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = _flash_bwd_reference(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """Attention over [B, H, T, D] tensors (self-attention: q, k and v of
    one shape), differentiable. CUDA tensors launch the kernels; CPU
    tensors take the plain versions. `block_q`/`block_k` are the
    reference's Pallas block sizes, taken for its signature; the CUDA
    kernels use their own tiles (csrc/flash_attention.cu)."""
    _require(block_q > 0 and block_k > 0, "block sizes must be positive")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, bool(causal), float(scale))
