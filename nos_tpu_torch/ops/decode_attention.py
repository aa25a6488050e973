"""Cached decode attention over a dense KV cache: a hand-written CUDA kernel
for Hopper, with its plain PyTorch version beside it.

Port of `nos_tpu/ops/decode_attention.py`. The plain version is the
reference's `_reference` (:28) op for op; it is also the math the paged
reference (`ops/paged_attention.py::_reference`) runs on its gathered
cache. The TPU kernel (`_pallas`, :46) becomes `csrc/decode_attention.cu`,
the split-KV kernel of `csrc/split_decode.cuh` (see its header for the
design; route "split", the only one), built with nvcc and bound with ctypes
(`ops/_build.py`). It serves every single-token step of the dense programs
(`models/decode.py`: `prefill` of a one-token prompt, `decode_step`,
`decode_step_ragged`, `generate`).

`decode_attention` dispatches on the tensors' device: CUDA tensors always
launch the kernel (a failed build or launch raises, nothing falls back),
CPU tensors take `_reference`. `LAUNCHES` counts kernel launches, so a run
can show that its main path went through the kernel, and `ROUTE_LAUNCHES`
the same launches by route.
"""

from __future__ import annotations

from typing import Dict

import torch

from nos_tpu_torch.ops import _build

NEG_INF = -1e30

#: Kernel launches (incremented only where the kernel launches).
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

#: The same launches by route.
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {"decode_attention": {"split": 0}}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = {"split": 0}


def _reference(q, cache_k, cache_v, limit):
    """q [B,nh,hd]; cache [B,nkv,max,hd]; limit [B] -> [B,nh,hd]."""
    b, nh, hd = q.shape
    nkv = cache_k.shape[1]
    rep = nh // nkv
    qg = q.reshape(b, nkv, rep, hd)
    scale = hd ** -0.5
    s = torch.einsum("bgrd,bgsd->bgrs", qg.float(), cache_k.float()) * scale
    idx = torch.arange(cache_k.shape[2], device=q.device)
    mask = idx[None, :] < limit[:, None]  # [B, max]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bgsd->bgrd", p, cache_v.float())
    return o.reshape(b, nh, hd).to(q.dtype)


# -- the CUDA kernel -----------------------------------------------------------
_VP, _I = _build.VP, _build.I
_require = _build.require
_SIGNATURES = {"nos_decode_attention": [_VP] * 7 + [_I] * 6 + [_build.F, _build.LL, _build.LL,
                                                                _VP]}


def _kernel(q, cache_k, cache_v, limit):
    dev = q.device
    for t in (q, cache_k, cache_v, limit):
        _require(t.device == dev, "all tensors must lie on {}, got {}", dev, t.device)
        _require(t.is_contiguous(), "the kernel takes contiguous tensors only")
    _require(q.dtype in _DTYPE_CODE, "q must be float32 or bfloat16, got {}", q.dtype)
    _require(cache_k.dtype == q.dtype and cache_v.dtype == q.dtype,
             "the cache must match q's dtype ({}, {} vs {})", cache_k.dtype, cache_v.dtype,
             q.dtype)
    _require(q.dim() == 3, "q must be [B, nh, hd]")
    b, nh, hd = q.shape
    _require(cache_k.dim() == 4 and cache_v.shape == cache_k.shape,
             "caches must be [B, nkv, max, hd]")
    _, nkv, max_len, _ = cache_k.shape
    _require(cache_k.shape[0] == b and cache_k.shape[3] == hd and nh % nkv == 0,
             "q does not match the cache's batch, heads or head_dim")
    _require(hd % 8 == 0 and 0 < hd <= 256, "head_dim must be a multiple of 8 up to 256, got {}",
             hd)
    _require(max_len > 0, "the cache must hold at least one position")
    _require(limit.dtype == torch.int32 and limit.shape == (b,), "limit must be [B] int32")
    out = torch.empty_like(q)
    part, counters = _build.split_scratch(q, b * nkv, nh // nkv, hd, max_len)
    lib = _build.load("decode_attention", _SIGNATURES)
    rc = lib.nos_decode_attention(
        _VP(q.data_ptr()), _VP(cache_k.data_ptr()), _VP(cache_v.data_ptr()),
        _VP(limit.data_ptr()), _VP(out.data_ptr()), _VP(part.data_ptr()),
        _VP(counters.data_ptr()), b, nh, nkv, hd, max_len, _DTYPE_CODE[q.dtype], hd ** -0.5,
        part.numel(), counters.numel(), _build.stream(q),
    )
    _build.raise_on(lib, rc, "decode_attention")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, "decode_attention", "split")
    return out


def decode_attention(q, cache_k, cache_v, limit):
    """Single-token cached attention: q [B,nh,hd] over caches [B,nkv,max,hd]
    with per-row attention limits [B] (int32 on CUDA). CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    if q.device.type == "cuda":
        return _kernel(q, cache_k, cache_v, limit)
    if q.device.type == "cpu":
        return _reference(q, cache_k, cache_v, limit)
    raise ValueError(f"decode attention runs on cuda or cpu, not {q.device}")
