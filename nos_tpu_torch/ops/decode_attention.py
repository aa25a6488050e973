"""Cached decode attention, plain PyTorch version.

Port of `nos_tpu/ops/decode_attention.py:28` (`_reference`): the math the
paged reference (`ops/paged_attention.py::_reference`) calls on its gathered
cache. The dense single-token kernel (`decode_attention.py:46`, `_pallas`)
serves only the dense `prefill`/`decode_step`/`generate` programs, which are
a later slice of the port.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
