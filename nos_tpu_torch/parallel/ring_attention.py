"""Ring and Ulysses attention: exact attention over sequence-sharded q/k/v.

Port of `nos_tpu/parallel/ring_attention.py`: `_block_attn` (:31),
`_ring_attention_local` (:51), `ring_attention` (:100), `ulysses_attention`
(:125), `_local_full_attention` (:162) and `reference_attention` (:174).
The JAX package computes them with einsums outside any Pallas kernel, so
the port's are plain torch. Each per-rank program runs here for every rank
of one sp group at once (the port's single controller), over the
collectives of `parallel/collectives.py`: ring attention streams K/V blocks
around the ring with an online softmax, Ulysses swaps the sequence sharding
for a head sharding with two all-to-alls. `*_shards` take and return the
per-rank lists (what `models/gpt.py`'s mesh path calls); `ring_attention`
and `ulysses_attention` take global [B, H, T, D] tensors and a mesh, as the
reference's do, and return the global result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from nos_tpu_torch.parallel import collectives as col
from nos_tpu_torch.parallel.mesh import Mesh
from nos_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor


def _einsum_f32(eq: str, a, b):
    """einsum with f32 products and sums (`preferred_element_type=f32`)."""
    return torch.einsum(eq, a.float(), b.float())


def _block_attn(q, k, v, bias=None):
    """One q-block x k-block contribution with running stats, f32:
    (unnormalized output, row max, row sum-exp). A fully masked row has
    max -inf and contributes zero."""
    s = _einsum_f32("bhqd,bhkd->bhqk", q, k)
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = _einsum_f32("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o, m, l


def ring_attention_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], causal: bool = False,
                          scale: Optional[float] = None) -> List[torch.Tensor]:
    """`_ring_attention_local` on every rank of one ring: qs[i], ks[i],
    vs[i] are rank i's [B, H, T/n, D] blocks of the sequence, in order. q
    is scaled and cast back to its dtype before any product (in bf16 that
    rounding is part of the result); the causal mask uses the global
    positions of each block's source rank. -> rank i's output block."""
    n = len(qs)
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    qs = [(q * scale).to(q.dtype) for q in qs]
    t_q, t_k = qs[0].shape[2], ks[0].shape[2]
    o_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    m_acc = [torch.full(q.shape[:3], -torch.inf, device=q.device) for q in qs]
    l_acc = [torch.zeros(q.shape[:3], device=q.device) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for r in range(n):
        for i, q in enumerate(qs):
            bias = None
            if causal:
                src = (i - r) % n
                q_pos = i * t_q + torch.arange(t_q, device=q.device)[:, None]
                k_pos = src * t_k + torch.arange(t_k, device=q.device)[None, :]
                zero = torch.zeros((), device=q.device)
                bias = torch.where(q_pos >= k_pos, zero, zero - torch.inf)[None, None]
            o, m, l = _block_attn(q, k_cur[i], v_cur[i], bias)
            m_new = torch.maximum(m_acc[i], m)
            zeros = torch.zeros_like(m)
            alpha = torch.where(torch.isneginf(m_acc[i]), zeros, torch.exp(m_acc[i] - m_new))
            beta = torch.where(torch.isneginf(m), zeros, torch.exp(m - m_new))
            o_acc[i] = o_acc[i] * alpha[..., None] + o * beta[..., None]
            l_acc[i] = l_acc[i] * alpha + l * beta
            m_acc[i] = m_new
        if r + 1 < n:  # the reference's last pass moves blocks no step reads
            k_cur, v_cur = col.ring_pass(k_cur), col.ring_pass(v_cur)
    return [(o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
            for o, l, q in zip(o_acc, l_acc, qs)]


def _masked_scores(q, k, causal: bool, scale: float):
    s = _einsum_f32("bhqd,bhkd->bhqk", q * scale, k)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=s.device).tril(t_k - t_q)
        s = s.masked_fill(~mask, -torch.inf)
    return s


def _local_full_attention(q, k, v, causal: bool, scale: float):
    """Full-length attention over local heads: q*scale in q's dtype, f32
    scores and softmax, the weights cast to v's dtype before PV."""
    p = torch.softmax(_masked_scores(q, k, causal, scale), dim=-1)
    return _einsum_f32("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def reference_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Plain attention for correctness checks (the reference's :174)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _local_full_attention(q, k, v, causal, scale)


def ulysses_attention_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], causal: bool = False,
                             scale: Optional[float] = None) -> List[torch.Tensor]:
    """Ulysses on every rank of one sp group: an all-to-all turns rank
    i's [B, H, T/n, D] sequence block into [B, H/n, T, D] (its head
    group over the whole sequence), each rank attends in full, and a
    second all-to-all restores the sequence sharding."""
    n = len(qs)
    if qs[0].shape[1] % n != 0:
        raise ValueError(f"heads {qs[0].shape[1]} not divisible by sp={n}")
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5

    def to_heads(xs):
        return col.all_to_all(xs, split_axis=1, concat_axis=2)

    os = [_local_full_attention(q, k, v, causal, scale)
          for q, k, v in zip(to_heads(qs), to_heads(ks), to_heads(vs))]
    return col.all_to_all(os, split_axis=2, concat_axis=1)


def _over_mesh(fn, q, k, v, mesh: Mesh, axis_name: str, causal: bool, scale):
    """Run the per-rank program `fn` on q/k/v sharded as P(dp, None,
    axis_name, None) over every group of `axis_name`; -> the global
    output."""
    dp = "dp" if "dp" in mesh.shape else None
    spec = (dp, None, axis_name, None)
    qs, ks, vs = (shard_tensor(x, mesh, spec) for x in (q, k, v))
    out: List[torch.Tensor] = [None] * len(qs)  # type: ignore[list-item]
    for group in mesh.groups(axis_name):
        res = fn([qs[p] for p in group], [ks[p] for p in group], [vs[p] for p in group],
                 causal, scale)
        for p, o in zip(group, res):
            out[p] = o
    return unshard_tensor(out, mesh, spec, q.device)


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention with q/k/v of global shape [B, H, T, D], the
    sequence sharded over `axis_name` and the batch over "dp" when the
    mesh has it; -> the global output."""
    return _over_mesh(ring_attention_shards, q, k, v, mesh, axis_name, causal, scale)


def ulysses_attention(q, k, v, mesh: Mesh, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses sequence parallelism over `axis_name` (heads must
    divide by its size); -> the global output."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n != 0:
        raise ValueError(f"heads {q.shape[1]} not divisible by {axis_name}={n}")
    return _over_mesh(ulysses_attention_shards, q, k, v, mesh, axis_name, causal, scale)
