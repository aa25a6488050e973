"""Mixture-of-Experts with expert parallelism over the `ep` mesh axis.

Port of `nos_tpu/parallel/moe.py`: `init_moe` (:33), `_moe_local` (:44)
and `moe_apply` (:123). Token-choice top-k routing with capacity, the
experts split over `ep`, and the two all-to-all hops: each token goes to
the rank that holds its expert, the local expert FFN runs over the capacity
buffer, and the results come back. top_k 1 is the Switch construction (the
raw probability as gate), top_k 2 GShard/Mixtral (gates renormalized over
the chosen pair). Capacity is assigned choice-major: every token's first
choice queues before any second choice, so under pressure second choices
overflow first. The aux output is the Switch load-balancing loss (eq. 4),
averaged over every rank. The reference's `shard_map` program runs here
for every rank of one ep group at once, over `parallel/collectives.py`.
`lax.top_k` breaks ties by the lowest index, which `torch.topk` does not
promise: the port sorts with a stable descending sort. `.at[...].add`
becomes an accumulating `index_put`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch.device import resolve
from nos_tpu_torch.parallel import collectives as col
from nos_tpu_torch.parallel.mesh import Mesh
from nos_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor


def init_moe(hidden: int, mlp_dim: int, n_experts: int, dtype=torch.bfloat16,
             generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """The reference's shapes and scales (:33-41): an f32 router [hidden,
    E] and expert weights w_in [E, hidden, mlp_dim], w_out [E, mlp_dim,
    hidden] in `dtype`, drawn on the CPU from `generator` (not JAX's RNG),
    then moved to `device` (None: CUDA)."""
    device = resolve(device, "init_moe")
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal(shape, scale, dt):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    scale_in, scale_out = hidden ** -0.5, mlp_dim ** -0.5
    return {
        "router": normal((hidden, n_experts), scale_in, torch.float32),
        "w_in": normal((n_experts, hidden, mlp_dim), scale_in, dtype),
        "w_out": normal((n_experts, mlp_dim, hidden), scale_out, dtype),
    }


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k`: the k largest along the last axis, ties to the lowest
    index (a stable sort keeps equal entries in index order)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(params, x, n_experts: int, capacity: int, top_k: int):
    """One rank's routing (:55-83): x [t, h] -> (gates [t, k], expert
    [t, k], slot [t, k], kept [t, k], aux loss)."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gate, idx = _top_k(probs, top_k)
    if top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=x.device)
    slots = []
    for c in range(top_k):
        onehot = F.one_hot(idx[:, c], n_experts)
        position = torch.cumsum(onehot, dim=0) * onehot  # 1-based within the round
        slots.append(position.sum(dim=-1) - 1 + counts[idx[:, c]])
        counts = counts + onehot.sum(dim=0)
    slot = torch.stack(slots, dim=1)
    frac = F.one_hot(idx[:, 0], n_experts).float().mean(dim=0)
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    return gate, idx, slot, slot < capacity, aux


def _moe_local(params: List[Dict], xs: List[torch.Tensor], n_experts: int, capacity: int,
               top_k: int = 1):
    """The per-rank program on every rank of one ep group: params[r] holds
    rank r's router and its E/ep experts, xs[r] its tokens [t, h]. ->
    (per-rank y [t, h], per-rank aux, per-rank kept [t, k])."""
    ep = len(xs)
    local_experts = params[0]["w_in"].shape[0]
    routes = [_route(p, x, n_experts, capacity, top_k) for p, x in zip(params, xs)]
    dispatch = []
    for x, (_, idx, slot, kept, _) in zip(xs, routes):
        buf = torch.zeros((n_experts, capacity, x.shape[1]), dtype=x.dtype, device=x.device)
        safe = slot.clamp(0, capacity - 1)
        for c in range(top_k):
            buf = buf.index_put((idx[:, c], safe[:, c]),
                                torch.where(kept[:, c, None], x, torch.zeros_like(x)),
                                accumulate=True)
        dispatch.append(buf.reshape(ep, local_experts, capacity, x.shape[1]))
    # Hop 1: [ep(dst), local, cap, h] -> [ep(src), local, cap, h] on each rank.
    dispatch = col.all_to_all(dispatch, split_axis=0, concat_axis=0, tiled=False)
    outs = []
    for p, d in zip(params, dispatch):
        h = d.shape[-1]
        d = d.transpose(0, 1).reshape(local_experts, ep * capacity, h)
        hmid = torch.einsum("ech,ehm->ecm", d.float(), p["w_in"].float())
        hmid = F.gelu(hmid, approximate="tanh").to(d.dtype)
        out = torch.einsum("ecm,emh->ech", hmid.float(), p["w_out"].float()).to(d.dtype)
        outs.append(out.reshape(local_experts, ep, capacity, h).transpose(0, 1))
    # Hop 2: the results back to the ranks that own the tokens.
    outs = col.all_to_all(outs, split_axis=0, concat_axis=0, tiled=False)
    ys = []
    for x, out, (gate, idx, slot, kept, _) in zip(xs, outs, routes):
        out = out.reshape(n_experts, capacity, x.shape[1])
        safe = slot.clamp(0, capacity - 1)
        y = torch.zeros_like(x)
        for c in range(top_k):
            contrib = out[idx[:, c], safe[:, c]] * gate[:, c, None].to(out.dtype)
            y = y + torch.where(kept[:, c, None], contrib, torch.zeros_like(contrib))
        ys.append(y)
    return ys, [r[4] for r in routes], [r[3] for r in routes]


def moe_apply(params: Dict, x: torch.Tensor, mesh: Mesh, axis_name: str = "ep",
              capacity_factor: float = 2.0, top_k: int = 1, return_aux: bool = False):
    """Apply the MoE layer. x: [B, T, H], the batch over "dp" when the mesh
    has it and the sequence over `axis_name`; expert weights sharded over
    `axis_name`. Returns [B, T, H], or (y, aux_loss) with `return_aux`:
    the load-balancing term averaged over every rank. Capacity per rank is
    capacity_factor * top_k * local tokens / E, at least 1."""
    ep = mesh.shape[axis_name]
    n_experts = params["w_in"].shape[0]
    if n_experts % ep != 0:
        raise ValueError(f"{n_experts} experts not divisible by ep={ep}")
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
    b, t, h = x.shape
    if t % ep != 0:
        raise ValueError(f"sequence {t} not divisible by ep={ep}")
    dp = "dp" if "dp" in mesh.shape else None
    b_local = b // mesh.shape[dp] if dp else b
    local_tokens = b_local * (t // ep)
    capacity = max(1, int(capacity_factor * top_k * local_tokens / n_experts))
    data_spec = (dp, axis_name, None)
    xs = shard_tensor(x, mesh, data_spec)
    routers = shard_tensor(params["router"], mesh, ())
    w_in = shard_tensor(params["w_in"], mesh, (axis_name,))
    w_out = shard_tensor(params["w_out"], mesh, (axis_name,))
    ys: List[torch.Tensor] = [None] * len(xs)  # type: ignore[list-item]
    auxes = []
    for group in mesh.groups(axis_name):
        local = [{"router": routers[p], "w_in": w_in[p], "w_out": w_out[p]} for p in group]
        flat = [xs[p].reshape(-1, h) for p in group]
        y, aux, _ = _moe_local(local, flat, n_experts, capacity, top_k)
        for p, yy in zip(group, y):
            ys[p] = yy.reshape(xs[p].shape)
        auxes.extend(aux)
    y = unshard_tensor(ys, mesh, data_spec, x.device)
    if not return_aux:
        return y
    return y, torch.stack([a.to(x.device) for a in auxes]).mean()
