"""The training step, on one device or over a mesh.

Port of `nos_tpu/models/train.py`: `TrainConfig` (:26), `make_optimizer`
(:37), `init_train_state` (:44), `make_train_step` (:53) and
`synthetic_batch` (:78). optax's
`chain(clip_by_global_norm, adamw)` becomes optax's clip formula written
out, then `torch.optim.AdamW` with optax's defaults (betas 0.9/0.999, eps
1e-8, every leaf decayed, moments in the param dtype). torch applies the
decoupled decay before the Adam step where optax adds it to the update:
the same update, rounded at another place. The step updates params and
moments in place, where JAX returns new trees, and never waits on the
device.

With a mesh (:44-75) the params are a `MeshTree` under
`transformer_param_rules` (one tree per mesh position) and the batch is
split as P(dp, sp). One backward runs through the mesh path of
`gpt_loss`, each rank's term its NLL sum over the global count B x (T-1),
so the gradient of a block of a leaf is the sum of its copies' gradients:
an explicit `all_reduce_sum` over the positions that hold that block (dp
and sp replicas, and tp copies of a replicated leaf) gives every copy that
sum. The global-norm clip counts every block once (a tp-sharded leaf adds
its shards' squares, a replicated one counts one copy), and AdamW steps
every position's leaves, so replicas stay identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig, gpt_loss, init_gpt
from nos_tpu_torch.parallel import collectives as col
from nos_tpu_torch.parallel.sharding import (MeshTree, param_shardings, replica_groups,
                                             tree_leaves)


@dataclass(frozen=True)
class TrainConfig:
    model: GPTConfig = GPTConfig()
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # Sequence chunk of the vocabulary-projection loss (see gpt_loss).
    loss_chunk: int = 256


# (path, tensor) for each leaf of a nested param dict, in insertion order;
# paths join the keys with "/".
named_leaves = tree_leaves


def _leaves(tree) -> List[torch.Tensor]:
    """Every leaf of a param tree, or of every position of a MeshTree."""
    if isinstance(tree, MeshTree):
        return [t for shard in tree.shards for _, t in named_leaves(shard)]
    return [t for _, t in named_leaves(tree)]


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay) over every leaf of `params` (which
    become leaves that require grad). The global-norm clip is applied by
    the step (`_clip_by_global_norm`)."""
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    return torch.optim.AdamW(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_train_state(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
                     device=None, mesh=None):
    """Params (`init_gpt`) on `device` (None: CUDA) + their optimizer. With
    a mesh, the params are drawn on its first device and placed on every
    position (`param_shardings`); `device` must then be None."""
    if mesh is None:
        device = resolve(device, "init_train_state")
        params = init_gpt(cfg.model, generator, device=device)
        return params, make_optimizer(cfg, params)
    if device is not None:
        raise ValueError("init_train_state places params on the mesh's devices; pass no device")
    params = param_shardings(init_gpt(cfg.model, generator, device=mesh.devices[0]), mesh)
    return params, make_optimizer(cfg, params)


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         counted: Optional[List[torch.Tensor]] = None) -> None:
    """optax.clip_by_global_norm in place: g if norm < max_norm else
    g / norm * max_norm, the norm over the `counted` tensors (None: every
    one of `grads`; summed in f32 here) and cast to each leaf's dtype as
    optax casts it. No host sync: the branch is a select on the device."""
    counted = grads if counted is None else counted
    dev = counted[0].device
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32).to(dev) for g in counted]))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.device, g.dtype)).mul_(mul.to(g.device, g.dtype))


def _sum_replica_grads(params: MeshTree) -> List[torch.Tensor]:
    """Every copy of a block gets the sum of the copies' gradients
    (`all_reduce_sum`, in position order); a copy the loss did not reach
    counts zero. -> one gradient per distinct block, for the norm."""
    blocks = []
    for path, spec in tree_leaves(params.specs):
        leaves = params.leaves(path)
        for group in replica_groups(params.mesh, spec):
            copies = [leaves[p] for p in group]
            grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in copies]
            for x, total in zip(copies, col.all_reduce_sum(grads)):
                if x.grad is None:
                    x.grad = total.clone()
                elif x.grad is not total:
                    x.grad.copy_(total)
            blocks.append(copies[0].grad)
    return blocks


def make_train_step(cfg: TrainConfig, mesh=None):
    """The train step: step(params, opt_state, tokens) -> (params,
    opt_state, {"loss": loss}), with `opt_state` the optimizer of
    `make_optimizer`/`init_train_state`. Params and moments are updated in
    place; the returned loss is a device scalar. With a mesh, `params` is
    the MeshTree of `init_train_state(..., mesh=)` and `tokens` the global
    [B, T] batch or its per-position blocks (`prefetch_to_mesh` with
    `batch_sharding(mesh, "dp", "sp")`)."""

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        opt_state.zero_grad(set_to_none=True)
        loss = gpt_loss(params, tokens, cfg.model, mesh, loss_chunk=cfg.loss_chunk)
        loss.backward()
        if mesh is None:
            _clip_by_global_norm([p.grad for p in leaves], cfg.grad_clip)
        else:
            blocks = _sum_replica_grads(params)
            _clip_by_global_norm([p.grad for p in leaves], cfg.grad_clip, counted=blocks)
        opt_state.step()
        return params, opt_state, {"loss": loss.detach()}

    return step


def synthetic_batch(generator: torch.Generator, cfg: GPTConfig, batch: int, seq: int,
                    device=None) -> torch.Tensor:
    """[batch, seq] int32 tokens uniform in [0, vocab), drawn on the CPU
    from `generator` (not JAX's RNG), on `device` (None: CUDA)."""
    device = resolve(device, "synthetic_batch")
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator, dtype=torch.int32)
    return toks.to(device)
