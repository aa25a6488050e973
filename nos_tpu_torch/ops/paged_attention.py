"""Paged attention over a block-paged KV pool: hand-written CUDA kernels for
Hopper, with their plain PyTorch versions beside them.

Port of `nos_tpu/ops/paged_attention.py`. The TPU read path streamed each
sequence's pages straight from the pool with the page table as a
scalar-prefetch operand (`_pallas` :62, `_window_pallas` :288); here the
same contract is carried by `csrc/paged_attention.cu` (see its header for
the design), built with nvcc and bound with ctypes (`ops/_build.py`). The
window kernel has two routes, chosen by `_window_route` from dtypes and
shapes alone: "mma", a tensor-core kernel for a bf16 q over a bf16 pool or
over an int8 pool with its scales at head_dim 64, 128 or 256, and "simt"
for everything else (an f32 q over any pool, other head dims). The decode kernel has one route, "split": each lane's
keys in fixed splits over the card, combined in split order
(`csrc/split_decode.cuh`), for every dtype.

Both entry points take a `window` (0: none): a sliding layer's lower key
bound, each query row with limit L attending only keys L - window <= j < L;
the kernels then read no key below the bound's page (see
`csrc/paged_attention.cu`).

The public entry points dispatch on the tensors' device: CUDA tensors always
launch the kernel (a failed build or launch raises, nothing falls back), CPU
tensors take the plain gather versions, which are the reference's
`_reference` (:48) / `_window_reference` (:258) op for op. `LAUNCHES` counts
kernel launches per entry point, so a run can show that its main path went
through the kernels, and `ROUTE_LAUNCHES` the same launches by route. The
`_sharded` entry points (`_pallas_sharded` :193, `_window_pallas_sharded`
:226) run the same kernel once per tensor-parallel shard and count each of
those launches under their own name.
"""

from __future__ import annotations

from typing import Dict

import torch

from nos_tpu_torch.ops import _build

NEG_INF = -1e30

#: Kernel launches per entry point (incremented only where a kernel launches).
LAUNCHES: Dict[str, int] = {
    "paged_decode_attention": 0,
    "paged_window_attention": 0,
    "paged_decode_attention_sharded": 0,
    "paged_window_attention_sharded": 0,
}

#: The routes of each entry point: "split" for decode, "mma" or "simt" for
#: the window.
_ROUTES = {name: ("split",) if "decode" in name else ("mma", "simt") for name in LAUNCHES}

#: The same launches by entry point and route.
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: dict.fromkeys(routes, 0) for name, routes in _ROUTES.items()}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MMA_HEAD_DIMS = (64, 128, 256)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = dict.fromkeys(_ROUTES[name], 0)


def _window_route(q, pool_k, k_scale) -> str:
    """The window kernel's route, a pure function of dtypes and shapes:
    "mma" (csrc/paged_attention.cu's tensor-core kernel) for a bf16 q over a
    bf16 pool, or over an int8 pool with its scales, at head_dim 64, 128 or
    256; "simt" for an f32 q over any pool, or any other head_dim."""
    native = pool_k.dtype == torch.bfloat16 and k_scale is None
    quant = pool_k.dtype == torch.int8 and k_scale is not None
    if q.dtype == torch.bfloat16 and (native or quant) and pool_k.shape[-1] in _MMA_HEAD_DIMS:
        return "mma"
    return "simt"


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


def _reference(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None, window=0):
    """The gather formulation: q [B,nh,hd]; pool [T,nkv,bs,hd]; table [B,P]
    int32; limit [B] -> [B,nh,hd]; `window` as `paged_decode_attention`'s."""
    from nos_tpu_torch.ops.decode_attention import _reference as dense_reference

    return dense_reference(
        q,
        _gather_pool(pool_k, table, k_scale, q.dtype),
        _gather_pool(pool_v, table, v_scale, q.dtype),
        limit,
        window,
    )


def _window_reference(q, pool_k, pool_v, table, pos, lengths, mask,
                      k_scale=None, v_scale=None, window=0):
    """The gather formulation of the windowed read: q [B,nh,W,hd]; pool
    [T,nkv,bs,hd]; table [B,P]; pos/lengths [B]; mask [B] bool ->
    [B,nh,W,hd]. Invalid rows attend the scratch page's first position only
    (an all-masked row would softmax to NaN); `window` as
    `paged_window_attention`'s."""
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
        window,
    )


# -- the CUDA kernels ----------------------------------------------------------
_VP, _I = _build.VP, _build.I
_require = _build.require
_SIGNATURES = {
    "nos_paged_decode_attention": [_VP] * 10 + [_I] * 8 + [_build.F, _build.LL, _build.LL,
                                                          _I, _VP],
    "nos_paged_window_attention": [_VP] * 10 + [_I] * 9 + [_build.F, _I, _VP],
    "nos_paged_window_attention_mma": [_VP] * 10 + [_I] * 8 + [_build.F, _I, _VP],
}


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def _check_common(q, pool_k, pool_v, table, k_scale, v_scale):
    """Device, dtype, shape and contiguity checks shared by both kernels;
    returns (dtype codes, scale pointers). The window's simt launcher
    itself refuses a block_size x head_dim whose CUDA block would not fit
    shared memory."""
    dev = q.device
    tensors = [q, pool_k, pool_v, table]
    if k_scale is not None or v_scale is not None:
        _require(k_scale is not None and v_scale is not None,
                 "k_scale and v_scale come together")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _require(t.device == dev, "all tensors must lie on {}, got {}", dev, t.device)
        _require(t.is_contiguous(), "the kernel takes contiguous tensors only")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             "q must be float32 or bfloat16, got {}", q.dtype)
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
                 "a native pool must match q's dtype ({} vs {})", pool_k.dtype, q.dtype)
    _require(pool_k.dim() == 4 and pool_v.shape == pool_k.shape,
             "pools must be [total_blocks, nkv, block, hd]")
    hd = pool_k.shape[3]
    _require(hd % 8 == 0 and 0 < hd <= 256, "head_dim must be a multiple of 8 up to 256, got {}",
             hd)
    _require(table.dtype == torch.int32 and table.dim() == 2, "table must be [B, P] int32")
    scales = (_VP(k_scale.data_ptr()), _VP(v_scale.data_ptr())) if quant else (None, None)
    return _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype], scales


def _window_keys(window: int, block_size: int, n_pages: int) -> int:
    """Keys a lane's splits can span: every addressable one, or with a
    window the window plus the part of its first page below it."""
    keys = n_pages * block_size
    return min(keys, window + block_size - 1) if window > 0 else keys


def _decode_kernel(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None, window=0,
                   count="paged_decode_attention"):
    b, nh, hd = q.shape
    nkv = pool_k.shape[1]
    _require(nh % nkv == 0 and pool_k.shape[3] == hd, "q does not match the pool's heads")
    _require(table.shape[0] == b, "table rows must match the batch")
    _require(limit.dtype == torch.int32 and limit.shape == (b,) and limit.is_contiguous()
             and limit.device == q.device, "limit must be [B] int32 on q's device")
    qc, kc, (ks, vs) = _check_common(q, pool_k, pool_v, table, k_scale, v_scale)
    bs, n_pages = pool_k.shape[2], table.shape[1]
    out = torch.empty_like(q)
    _require(window >= 0 and not (window and k_scale is not None),
             "window must be >= 0, and 0 over an int8 pool")
    part, counters = _build.split_scratch(q, b * nkv, nh // nkv, hd,
                                          _window_keys(window, bs, n_pages))
    lib = _lib()
    rc = lib.nos_paged_decode_attention(
        _VP(q.data_ptr()), _VP(pool_k.data_ptr()), _VP(pool_v.data_ptr()), ks, vs,
        _VP(table.data_ptr()), _VP(limit.data_ptr()), _VP(out.data_ptr()),
        _VP(part.data_ptr()), _VP(counters.data_ptr()),
        b, nh, nkv, hd, bs, n_pages, qc, kc, hd ** -0.5, part.numel(), counters.numel(),
        int(window), _build.stream(q),
    )
    _build.raise_on(lib, rc, "paged_decode_attention")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, count, "split")
    return out


def _window_kernel(q, pool_k, pool_v, table, pos, lengths, mask,
                   k_scale=None, v_scale=None, window=0, count="paged_window_attention"):
    b, nh, w, hd = q.shape
    nkv = pool_k.shape[1]
    _require(nh % nkv == 0 and pool_k.shape[3] == hd, "q does not match the pool's heads")
    _require(table.shape[0] == b, "table rows must match the batch")
    for name, t, dt in (("pos", pos, torch.int32), ("lengths", lengths, torch.int32),
                        ("mask", mask, torch.bool)):
        _require(t.dtype == dt and t.shape == (b,) and t.is_contiguous()
                 and t.device == q.device, "{} must be [B] {} on q's device", name, dt)
    qc, kc, (ks, vs) = _check_common(q, pool_k, pool_v, table, k_scale, v_scale)
    _require(window >= 0, "window must be >= 0")
    route = _window_route(q, pool_k, k_scale)
    _require(not (window and route == "mma" and k_scale is not None),
             "the mma route takes no window over an int8 pool")
    out = torch.empty_like(q)
    lib = _lib()
    ptrs = [_VP(x.data_ptr()) for x in (q, pool_k, pool_v)]
    rows = [_VP(x.data_ptr()) for x in (table, pos, lengths, mask, out)]
    dims = (b, nh, nkv, w, hd, pool_k.shape[2], table.shape[1])
    if route == "mma":
        rc = lib.nos_paged_window_attention_mma(*ptrs, ks, vs, *rows, *dims, kc, hd ** -0.5,
                                                int(window), _build.stream(q))
    else:
        rc = lib.nos_paged_window_attention(*ptrs, ks, vs, *rows, *dims, qc, kc, hd ** -0.5,
                                            int(window), _build.stream(q))
    _build.raise_on(lib, rc, f"paged_window_attention ({route})")
    _build.count_launch(LAUNCHES, ROUTE_LAUNCHES, count, route)
    return out


# -- public entry points -------------------------------------------------------
def _on_cuda(q) -> bool:
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"paged attention runs on cuda or cpu, not {q.device}")


def paged_decode_attention(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None,
                           window: int = 0):
    """Single-token attention over a block-paged KV pool: q [B,nh,hd], pools
    [total_blocks,nkv,block,hd], table [B,P] page ids (rows beyond a
    sequence's allocation point at the scratch page), limit [B]: lane b
    attends keys j < limit[b], and with a `window` > 0 (a sliding layer's)
    only those with j >= limit[b] - window. `k_scale`/`v_scale` [T] f32: the
    pools are int8 with per-block scales. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if _on_cuda(q):
        return _decode_kernel(q, pool_k, pool_v, table, limit, k_scale, v_scale, window)
    return _reference(q, pool_k, pool_v, table, limit, k_scale, v_scale, window)


def paged_window_attention(q, pool_k, pool_v, table, pos, lengths, mask,
                           k_scale=None, v_scale=None, window: int = 0):
    """Windowed-query attention over a block-paged KV pool: q [B,nh,W,hd],
    table [B,P], pos [B] window base positions, lengths [B] valid window
    lengths, mask [B] active lanes. Query (b, w) attends its pages up to
    pos[b]+w+1 while w < lengths[b] and mask[b], and with a `window` > 0
    (a sliding layer's) only from pos[b]+w+1-window; other rows attend only
    the first position of their first page (garbage the caller ignores,
    never NaN; with a window the kernel may give them 0 instead). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if _on_cuda(q):
        return _window_kernel(q, pool_k, pool_v, table, pos, lengths, mask,
                              k_scale, v_scale, window)
    return _window_reference(q, pool_k, pool_v, table, pos, lengths, mask,
                             k_scale, v_scale, window)


# -- tensor-parallel sharding (docs/sharded-decode.md) -------------------------
def _tp_width(mesh, tp_axis) -> int:
    """The width of `tp_axis` on `mesh`; 1 without a mesh or the axis."""
    if mesh is None or tp_axis is None or tp_axis not in mesh.shape:
        return 1
    return int(mesh.shape[tp_axis])


def _replicated(x, devices):
    """A replicated operand as one tensor per shard: a per-shard list as it
    is, a single tensor moved to each shard's device (no copy where it
    already lies)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return [None if x is None else x.to(d) for d in devices]


def paged_decode_attention_sharded(q, pool_k, pool_v, table, limit,
                                   k_scale=None, v_scale=None):
    """`paged_decode_attention` on a tensor-parallel mesh
    (`nos_tpu/ops/paged_attention.py::_pallas_sharded`, :193). `q`,
    `pool_k` and `pool_v` are per-shard lists in shard order: shard s holds
    q [B, nh/tp, hd] and its pools [T, nkv/tp, bs, hd], head slices of every
    block. The table and the limits are replicated (a tensor, or one per
    shard); the int8 scales [T] likewise, and the engine hands each shard
    its own copy (a list, as for the pools). Each shard runs the unchanged kernel over its
    own nkv/tp groups (its plain version on a CPU shard); the
    per-(sequence, group) math never crosses heads, so every head's output
    is bit for bit the unsharded kernel's. No collective runs: the result
    is the per-shard outputs [B, nh/tp, hd], each on its shard's device."""
    devices = [x.device for x in q]
    table, limit = _replicated(table, devices), _replicated(limit, devices)
    k_scale, v_scale = _replicated(k_scale, devices), _replicated(v_scale, devices)
    out = []
    for s in range(len(q)):
        args = (q[s], pool_k[s], pool_v[s], table[s], limit[s], k_scale[s], v_scale[s])
        if _on_cuda(q[s]):
            out.append(_decode_kernel(*args, count="paged_decode_attention_sharded"))
        else:
            out.append(_reference(*args))
    return out


def paged_window_attention_sharded(q, pool_k, pool_v, table, pos, lengths, mask,
                                   k_scale=None, v_scale=None):
    """`paged_window_attention` on a tensor-parallel mesh
    (`_window_pallas_sharded`, :226), the same way as
    `paged_decode_attention_sharded`: q [B, nh/tp, W, hd] and the pools per
    shard; the table, pos, lengths, mask and scales replicated (a tensor,
    or one per shard). Returns the per-shard outputs [B, nh/tp, W, hd]."""
    devices = [x.device for x in q]
    table, pos = _replicated(table, devices), _replicated(pos, devices)
    lengths, mask = _replicated(lengths, devices), _replicated(mask, devices)
    k_scale, v_scale = _replicated(k_scale, devices), _replicated(v_scale, devices)
    out = []
    for s in range(len(q)):
        args = (q[s], pool_k[s], pool_v[s], table[s], pos[s], lengths[s], mask[s],
                k_scale[s], v_scale[s])
        if _on_cuda(q[s]):
            out.append(_window_kernel(*args, count="paged_window_attention_sharded"))
        else:
            out.append(_window_reference(*args))
    return out
