"""Paged attention over a block-paged KV pool: hand-written CUDA kernels for
Hopper, with their plain PyTorch versions beside them.

Port of `nos_tpu/ops/paged_attention.py`. The TPU read path streamed each
sequence's pages straight from the pool with the page table as a
scalar-prefetch operand (`_pallas` :62, `_window_pallas` :288); here the
same contract is carried by `csrc/paged_attention.cu` (see its header for
the design), built with nvcc and bound with ctypes (`ops/_build.py`).

The public entry points dispatch on the tensors' device: CUDA tensors always
launch the kernel (a failed build or launch raises, nothing falls back), CPU
tensors take the plain gather versions, which are the reference's
`_reference` (:48) / `_window_reference` (:258) op for op. `LAUNCHES` counts
kernel launches per entry point, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from nos_tpu_torch.ops import _build

NEG_INF = -1e30

#: Kernel launches per entry point (incremented only where a kernel launches).
LAUNCHES: Dict[str, int] = {
    "paged_decode_attention": 0,
    "paged_window_attention": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ------------------------------------------------------------
def _gather_pool(pool, table, scale, out_dtype):
    """Materialize `pool[table]` -> [B, nkv, P*bs, hd]. With a per-block
    `scale` [T] the pool is int8 and the gather dequantizes it
    (row * scale[block]), cast to `out_dtype`."""
    g = pool[table.long()]  # [B, P, nkv, bs, hd]
    b, p, nkv, bs, hd = g.shape
    if scale is not None:
        s = scale[table.long()]  # [B, P]
        g = (g.float() * s[:, :, None, None, None]).to(out_dtype)
    return g.permute(0, 2, 1, 3, 4).reshape(b, nkv, p * bs, hd)


def _reference(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None):
    """The gather formulation: q [B,nh,hd]; pool [T,nkv,bs,hd]; table [B,P]
    int32; limit [B] -> [B,nh,hd]."""
    from nos_tpu_torch.ops.decode_attention import _reference as dense_reference

    return dense_reference(
        q,
        _gather_pool(pool_k, table, k_scale, q.dtype),
        _gather_pool(pool_v, table, v_scale, q.dtype),
        limit,
    )


def _window_reference(q, pool_k, pool_v, table, pos, lengths, mask,
                      k_scale=None, v_scale=None):
    """The gather formulation of the windowed read: q [B,nh,W,hd]; pool
    [T,nkv,bs,hd]; table [B,P]; pos/lengths [B]; mask [B] bool ->
    [B,nh,W,hd]. Invalid rows attend the scratch page's first position only
    (an all-masked row would softmax to NaN)."""
    from nos_tpu_torch.models.decode import _attend_cache

    b, nh, w, hd = q.shape
    nkv = pool_k.shape[1]
    offs = torch.arange(w, dtype=torch.int32, device=q.device)
    positions = pos[:, None] + offs[None, :]
    valid = (offs[None, :] < lengths[:, None]) & mask[:, None]
    limit = torch.where(valid, positions + 1, torch.ones_like(positions))
    return _attend_cache(
        q,
        _gather_pool(pool_k, table, k_scale, q.dtype),
        _gather_pool(pool_v, table, v_scale, q.dtype),
        nh // nkv,
        limit,
    )


# -- the CUDA kernels ----------------------------------------------------------
_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_nos_bound", False):
        lib.nos_paged_decode_attention.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
            _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _VP,
        ]
        lib.nos_paged_decode_attention.restype = _I
        lib.nos_paged_window_attention.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _VP,
        ]
        lib.nos_paged_window_attention.restype = _I
        lib.nos_cuda_error_string.argtypes = [_I]
        lib.nos_cuda_error_string.restype = ctypes.c_char_p
        lib._nos_bound = True
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(q, pool_k, pool_v, table, k_scale, v_scale):
    """Device, dtype, shape and contiguity checks shared by both kernels;
    returns (dtype codes, scale pointers). The launcher itself refuses a
    block_size x head_dim whose CUDA block would not fit shared memory."""
    dev = q.device
    tensors = [q, pool_k, pool_v, table]
    if k_scale is not None or v_scale is not None:
        _require(k_scale is not None and v_scale is not None,
                 "k_scale and v_scale come together")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _require(t.device == dev, f"all tensors must lie on {dev}, got {t.device}")
        _require(t.is_contiguous(), "the kernel takes contiguous tensors only")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q must be float32 or bfloat16, got {q.dtype}")
    _require(pool_k.dtype == pool_v.dtype, "K and V pools differ in dtype")
    quant = k_scale is not None
    if quant:
        _require(pool_k.dtype == torch.int8, "scales are for an int8 pool")
        _require(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
                 "scales must be float32")
        _require(k_scale.shape == (pool_k.shape[0],) and v_scale.shape == (pool_k.shape[0],),
                 "scales must be [total_blocks]")
    else:
        _require(pool_k.dtype == q.dtype,
                 f"a native pool must match q's dtype ({pool_k.dtype} vs {q.dtype})")
    _require(pool_k.dim() == 4 and pool_v.shape == pool_k.shape,
             "pools must be [total_blocks, nkv, block, hd]")
    hd = pool_k.shape[3]
    _require(hd % 8 == 0 and 0 < hd <= 256, f"head_dim must be a multiple of 8 up to 256, got {hd}")
    _require(table.dtype == torch.int32 and table.dim() == 2, "table must be [B, P] int32")
    scales = (_VP(k_scale.data_ptr()), _VP(v_scale.data_ptr())) if quant else (None, None)
    return _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype], scales


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().nos_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _decode_kernel(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None):
    b, nh, hd = q.shape
    nkv = pool_k.shape[1]
    _require(nh % nkv == 0 and pool_k.shape[3] == hd, "q does not match the pool's heads")
    _require(table.shape[0] == b, "table rows must match the batch")
    _require(limit.dtype == torch.int32 and limit.shape == (b,) and limit.is_contiguous()
             and limit.device == q.device, "limit must be [B] int32 on q's device")
    qc, kc, (ks, vs) = _check_common(q, pool_k, pool_v, table, k_scale, v_scale)
    out = torch.empty_like(q)
    rc = _lib().nos_paged_decode_attention(
        _VP(q.data_ptr()), _VP(pool_k.data_ptr()), _VP(pool_v.data_ptr()), ks, vs,
        _VP(table.data_ptr()), _VP(limit.data_ptr()), _VP(out.data_ptr()),
        b, nh, nkv, hd, pool_k.shape[2], table.shape[1], qc, kc, hd ** -0.5,
        _VP(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out


def _window_kernel(q, pool_k, pool_v, table, pos, lengths, mask,
                   k_scale=None, v_scale=None):
    b, nh, w, hd = q.shape
    nkv = pool_k.shape[1]
    _require(nh % nkv == 0 and pool_k.shape[3] == hd, "q does not match the pool's heads")
    _require(table.shape[0] == b, "table rows must match the batch")
    for name, t, dt in (("pos", pos, torch.int32), ("lengths", lengths, torch.int32),
                        ("mask", mask, torch.bool)):
        _require(t.dtype == dt and t.shape == (b,) and t.is_contiguous()
                 and t.device == q.device, f"{name} must be [B] {dt} on q's device")
    qc, kc, (ks, vs) = _check_common(q, pool_k, pool_v, table, k_scale, v_scale)
    out = torch.empty_like(q)
    rc = _lib().nos_paged_window_attention(
        _VP(q.data_ptr()), _VP(pool_k.data_ptr()), _VP(pool_v.data_ptr()), ks, vs,
        _VP(table.data_ptr()), _VP(pos.data_ptr()), _VP(lengths.data_ptr()),
        _VP(mask.data_ptr()), _VP(out.data_ptr()),
        b, nh, nkv, w, hd, pool_k.shape[2], table.shape[1], qc, kc, hd ** -0.5,
        _VP(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged_window_attention")
    LAUNCHES["paged_window_attention"] += 1
    return out


# -- public entry points -------------------------------------------------------
def _on_cuda(q) -> bool:
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"paged attention runs on cuda or cpu, not {q.device}")


def paged_decode_attention(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None):
    """Single-token attention over a block-paged KV pool: q [B,nh,hd], pools
    [total_blocks,nkv,block,hd], table [B,P] page ids (rows beyond a
    sequence's allocation point at the scratch page), limit [B]. `k_scale`/
    `v_scale` [T] f32: the pools are int8 with per-block scales. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if _on_cuda(q):
        return _decode_kernel(q, pool_k, pool_v, table, limit, k_scale, v_scale)
    return _reference(q, pool_k, pool_v, table, limit, k_scale, v_scale)


def paged_window_attention(q, pool_k, pool_v, table, pos, lengths, mask,
                           k_scale=None, v_scale=None):
    """Windowed-query attention over a block-paged KV pool: q [B,nh,W,hd],
    table [B,P], pos [B] window base positions, lengths [B] valid window
    lengths, mask [B] active lanes. Query (b, w) attends its pages up to
    pos[b]+w+1 while w < lengths[b] and mask[b]; other rows attend only the
    first position of their first page (garbage the caller ignores, never
    NaN). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if _on_cuda(q):
        return _window_kernel(q, pool_k, pool_v, table, pos, lengths, mask,
                              k_scale, v_scale)
    return _window_reference(q, pool_k, pool_v, table, pos, lengths, mask,
                             k_scale, v_scale)
